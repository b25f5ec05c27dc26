"""Model/shape configuration system (the same numbers as the JAX package).

One `ModelConfig` per assigned architecture (`configs/<id>.py`), the
four assigned input shapes, and `reduced()` — the same family shrunk for CPU
smoke tests (few layers, tiny dims) as the assignment prescribes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


# the four assigned LM shapes (assignment block)
TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | xlstm | rglru | whisper | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid / recurrent
    local_window: int = 2048
    layer_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn")
    slstm_every: int = 0                  # xlstm: 1 sLSTM per N blocks
    mlstm_chunk: int = 128                # chunkwise-parallel window
    conv_width: int = 4
    # whisper (enc-dec)
    n_enc_layers: int = 0
    n_frames: int = 1500
    # vlm
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_img_tokens: int = 256
    # numerics / training
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # which shapes this arch skips, with the reason (DESIGN.md §skips)
    skip_shapes: Tuple[str, ...] = ()
    sub_quadratic: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def runnable_shapes(self) -> Tuple[ShapeConfig, ...]:
        return tuple(s for s in ALL_SHAPES if s.name not in self.skip_shapes)

    def reduced(self) -> "ModelConfig":
        """Same-family CPU-smoke configuration (assignment: small layers,
        few experts, tiny tables)."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers,
                         4 if not self.layer_pattern
                         else len(self.layer_pattern) + 2),  # exercise tail
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frames=64 if self.n_frames else 0,
            n_img_tokens=16 if self.n_img_tokens else 0,
            local_window=64,
            mrope_sections=(4, 6, 6),
        )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 — populates the registry
    return _REGISTRY[name]


def all_configs() -> dict:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)
