"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2409.12191; hf] M-RoPE, dynamic resolution (vision frontend stubbed)
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

QWEN2_VL_2B = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, qkv_bias=True,
    rope_theta=1_000_000.0, mrope_sections=(16, 24, 24), n_img_tokens=256,
    skip_shapes=_FULL_ATTN_SKIP))
