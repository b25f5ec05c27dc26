"""Roofline terms of a step on the H100, from the dry-run's counts.

  compute_s    = flops / PEAK_FLOPS                (per device)
  memory_s     = bytes / HBM_BW                    (per device)
  collective_s = collective bytes / link rate      (per device)

The reference reads flops and bytes from XLA's `cost_analysis()` of one
device's program and parses collectives out of the optimized HLO text.
The port has neither: `launch/dryrun.py` counts the local ops of one
rank of a fake world (`CostMode`) and records the collectives DTensor
runs, and `collective_bytes` sums those records into the reference's
five kinds, counting each collective's per-device output bytes as the
reference counts output-shape payload.

The constants are one H100 SXM5 card's, from NVIDIA's H100 Tensor Core
GPU data sheet (dense, without sparsity), not the reference's TPU v5e
numbers:

  PEAK_FLOPS     989e12 FLOP/s  bf16 tensor-core peak, dense
  HBM_BW         3.35e12 B/s    HBM3
  NVLINK_BW      450e9 B/s      NVLink 4, each way (900 GB/s both ways),
                                to the other 7 cards of a host
  INTER_HOST_BW  50e9 B/s       one InfiniBand NDR port (400 Gb/s) a
                                card, as in DGX H100's published
                                compute fabric

A mesh axis picks its link by its group of ranks: laid out row-major
over hosts of 8 consecutive cards, a group that stays in one host would
use NVLink, any other the inter-host link. On the production meshes,
(16, 16) and (2, 16, 16), every axis group crosses hosts, so their
collectives go at INTER_HOST_BW: `ICI_BW`, the reference's name for the
one link rate `collective_s` divides by.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

# --- H100 SXM5 constants (NVIDIA data sheet) ---
PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # B/s / card
NVLINK_BW = 450e9            # B/s / card, each way, within a host
INTER_HOST_BW = 50e9         # B/s / card, InfiniBand NDR 400 Gb/s
ICI_BW = INTER_HOST_BW       # the production meshes' collective link

_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum (kind, per-device output bytes) records into the reference's
    five kinds."""
    out = {k: 0 for k in _COLL_OPS}
    for kind, nbytes in records:
        out[kind] += int(nbytes)
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    bytes_accessed: float
    coll_bytes: Dict[str, int]
    n_devices: int
    model_flops: float = 0.0     # 6·N·D (or 6·N_active·D) GLOBAL

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.total_coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global) — remat/padding waste."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(model-flops time at peak) / (roofline step time) — the score."""
        ideal = self.model_flops / (self.n_devices * PEAK_FLOPS)
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "coll_bytes_per_device": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "step_time_s": self.step_time_s,
            "n_devices": self.n_devices,
        }


def mfu(model_flops: float, step_s: float, n_devices: int = 1) -> float:
    """Model FLOPs utilisation of a measured step: model FLOPs over what
    `n_devices` cards at PEAK_FLOPS do in `step_s` seconds."""
    return model_flops / (step_s * n_devices * PEAK_FLOPS)


def model_flops_train(cfg, n_tokens: int) -> float:
    """6·N·D with N = active params (MoE: routed top-k only). As in the
    reference, Whisper's N counts its encoder too, over the B·T decoder
    tokens (its encoder runs on n_frames positions)."""
    n = active_params(cfg)
    return 6.0 * n * n_tokens


def model_flops_decode(cfg, batch: int, kv_len: int) -> float:
    """Per decode step: 2·N_active per token + attention KV reads
    (2·2·kv_len·H·Dh·layers MACs)."""
    n = active_params(cfg)
    flops = 2.0 * n * batch
    if cfg.family in ("dense", "moe", "vlm", "whisper"):
        att = cfg.n_layers * 2 * 2 * kv_len * cfg.n_heads * cfg.head_dim
        flops += att * batch
    elif cfg.family == "rglru":
        n_attn = cfg.n_layers // 3
        att = n_attn * 2 * 2 * min(kv_len, cfg.local_window) \
            * cfg.n_heads * cfg.head_dim
        flops += att * batch
    return flops


def active_params(cfg) -> float:
    E, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    emb = 2 * V * E
    if cfg.family in ("dense", "vlm"):
        per = (E * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * E
               + 3 * E * cfg.d_ff)
        return L * per + emb
    if cfg.family == "moe":
        per = (E * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * E
               + cfg.top_k * 3 * E * cfg.d_ff + E * cfg.n_experts)
        return L * per + emb
    if cfg.family == "whisper":
        attn = E * 4 * cfg.q_dim
        mlp = 2 * E * cfg.d_ff
        return (cfg.n_enc_layers * (attn + mlp)
                + L * (2 * attn + mlp)) + V * E
    if cfg.family == "xlstm":
        U = 2 * E
        m_per = E * 2 * U + 3 * U * U + U * 2 * cfg.n_heads + U * E
        s_per = E * 4 * E + 4 * (E // cfg.n_heads) * E \
            + 2 * E * ((4 * E) // 3)
        G = L // cfg.slstm_every
        return G * ((cfg.slstm_every - 1) * m_per + s_per) + emb
    if cfg.family == "rglru":
        rec = (2 * E * E + 2 * E * E + E * E) + 3 * E * cfg.d_ff
        attn = (E * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * E
                + 3 * E * cfg.d_ff)
        n_attn = L // 3
        return (L - n_attn) * rec + n_attn * attn + emb
    raise ValueError(cfg.family)
