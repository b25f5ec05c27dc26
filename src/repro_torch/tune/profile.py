"""`EncodeProfile` — the declared form of the encode-time knobs.

An archive's decode behaviour is fixed at encode time by four knobs
(`block_size`, `mode`, `entropy`, `anchor_interval`; `offset_bytes` is
implied by the first two). A profile is the value the autotuner
(`repro_torch.tune.autotune`) returns and every builder
(`encode(profile=...)`, `GenomicArchive.create`) accepts, so the choice
is made once, against a measured objective.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoder import validate_encode_params
from repro_torch.core.format import DEFAULT_BLOCK_SIZE


@dataclasses.dataclass(frozen=True)
class EncodeProfile:
    """One point of the encode-knob grid, validated at construction."""
    block_size: int = DEFAULT_BLOCK_SIZE
    mode: str = "ra"
    entropy: str = "rans"
    anchor_interval: int = 0

    def __post_init__(self):
        validate_encode_params(self.block_size, self.mode, self.entropy,
                               self.anchor_interval)

    @property
    def offset_bytes(self) -> int:
        """Implied by mode/block_size — mirrors the encoder's selection:
        block-local offsets need 2 or 4 planes, global offsets 8."""
        if self.mode == "ra":
            return 2 if self.block_size <= 0xFFFF else 4
        return 8

    def encode_kwargs(self) -> dict:
        return dict(block_size=self.block_size, mode=self.mode,
                    entropy=self.entropy,
                    anchor_interval=self.anchor_interval)

    def describe(self) -> str:
        # "/"-separated throughout: describe() lands in CSV derived
        # fields, where a comma would split the column
        anc = (f"/anchor={self.anchor_interval}" if self.anchor_interval
               else "")
        return (f"{self.mode}/{self.entropy}/block={self.block_size}"
                f"/off={self.offset_bytes}B{anc}")
