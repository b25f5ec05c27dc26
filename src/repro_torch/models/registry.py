"""Model registry: `--arch <id>` → model object (uniform interface).

Every model exposes: param_defs / init / loss / forward / cache_specs /
cache_axes / init_cache / decode_step / input_specs / input_axes.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def build_model(cfg_or_name):
    cfg = (cfg_or_name if isinstance(cfg_or_name, ModelConfig)
           else get_config(cfg_or_name))
    if cfg.family == "dense":
        from repro_torch.models.transformer import DenseLM
        return DenseLM(cfg)
    if cfg.family == "moe":
        from repro_torch.models.moe import MoELM
        return MoELM(cfg)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import XLSTM
        return XLSTM(cfg)
    if cfg.family == "rglru":
        from repro_torch.models.rglru import RecurrentGemma
        return RecurrentGemma(cfg)
    if cfg.family == "whisper":
        from repro_torch.models.whisper import Whisper
        return Whisper(cfg)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import VLM
        return VLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
