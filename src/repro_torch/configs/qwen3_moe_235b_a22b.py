"""Assigned architecture config — exact numbers from the assignment.

# [hf:Qwen/Qwen3-30B-A3B family; hf] 128 experts top-8, d_ff per expert
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

QWEN3_MOE = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, n_experts=128,
    top_k=8, rope_theta=1_000_000.0, skip_shapes=_FULL_ATTN_SKIP))
