"""Assigned architecture config — exact numbers from the assignment.

# [hf:xai-org/grok-1; unverified] 8 experts top-2
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

GROK1 = register(ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    skip_shapes=_FULL_ATTN_SKIP))
