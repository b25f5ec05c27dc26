"""Profile-guided encode autotuning: knob grid sweep → Pareto frontier →
`EncodeProfile` for a declared objective. See `repro_torch.tune.autotune`."""
from repro_torch.tune.autotune import (TunePoint, TuneResult, autotune,
                                       default_grid, pareto_frontier,
                                       validate_grid)
from repro_torch.tune.measure import measure_point, time_fn
from repro_torch.tune.profile import EncodeProfile

__all__ = [
    "EncodeProfile", "TunePoint", "TuneResult", "autotune", "default_grid",
    "measure_point", "pareto_frontier", "time_fn", "validate_grid",
]
