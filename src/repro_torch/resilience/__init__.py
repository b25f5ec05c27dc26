"""Self-healing decode: the detect → recover → degrade loop.

Every decode path digest-checks its rows on the device (FNV-1a-64 per
block); this package closes the loop. `parity` builds XOR parity over
k-block groups of compressed payload words (`encode(..., parity_group=k)`,
the `ACEJAX05` format tail) and rebuilds a corrupt payload on the device
from its group, `faults` injects seeded, deterministic failures into
every layer that can recover from them, and `chaos` sweeps the scenarios
end to end (`python -m repro_torch.resilience.chaos --smoke`).

Partial-failure semantics ride the query plane as `on_error`:

  "raise"   — detection is fatal (`BlockDigestError`), the default;
  "repair"  — single-block corruption heals transparently (parity
              reconstruction + one re-decode + re-verify); anything
              unrecoverable still raises;
  "partial" — unrecoverable blocks quarantine (never re-decoded, never
              served from the cache), their rows zero, and per-address
              typed outcomes flow to the caller instead of an exception.

Recovery composes at the decoder / residency layer; executors only
thread the knob through.
"""
from repro_torch.resilience.faults import (FaultInjector, PrefetchCrash,
                                           TransientDecodeError)
from repro_torch.resilience.parity import (build_parity, reconstruct_blocks,
                                           with_parity)

ON_ERROR_MODES = ("raise", "repair", "partial")


def check_on_error(on_error: str) -> str:
    """Validate an `on_error` knob (the single home of the constraint)."""
    if on_error not in ON_ERROR_MODES:
        raise ValueError(
            f"on_error={on_error!r} not in {ON_ERROR_MODES}")
    return on_error


__all__ = ["FaultInjector", "TransientDecodeError", "PrefetchCrash",
           "build_parity", "reconstruct_blocks", "with_parity",
           "ON_ERROR_MODES", "check_on_error"]
