"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

QWEN2_15B = register(ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
    rope_theta=1_000_000.0, skip_shapes=_FULL_ATTN_SKIP))
