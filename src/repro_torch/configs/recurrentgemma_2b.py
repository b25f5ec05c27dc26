"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2402.19427; hf] RG-LRU + local attention, 1 attn : 2 rec
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

RECURRENTGEMMA_2B = register(ModelConfig(
    name="recurrentgemma-2b", family="rglru", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    local_window=2048, layer_pattern=("rec", "rec", "attn"),
    sub_quadratic=True))
