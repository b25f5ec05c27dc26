"""Assigned architecture config — exact numbers from the assignment.

# [hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

QWEN15_32B = register(ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv_heads=40, d_ff=27392, vocab=152064, qkv_bias=True,
    rope_theta=1_000_000.0, skip_shapes=_FULL_ATTN_SKIP))
