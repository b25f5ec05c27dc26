"""Model registry: `--arch <id>` → model object.

The dense family (qwen1.5-32b, yi-6b, qwen2-1.5b, internlm2-1.8b) is
ported; the MoE, xLSTM, RG-LRU, Whisper and VLM families come with the
remaining-models slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.decoder import _not_in_slice


def build_model(cfg_or_name):
    cfg = (cfg_or_name if isinstance(cfg_or_name, ModelConfig)
           else get_config(cfg_or_name))
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg)
    if cfg.family in ("moe", "xlstm", "rglru", "whisper", "vlm"):
        raise _not_in_slice(f"the {cfg.family!r} model family ({cfg.name})",
                            "remaining-models")
    raise ValueError(f"unknown family {cfg.family!r}")
