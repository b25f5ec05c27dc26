"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2403.04652; hf] llama-arch GQA
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

YI_6B = register(ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab=64000, rope_theta=5_000_000.0,
    skip_shapes=_FULL_ATTN_SKIP))
