"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2212.04356; unverified] enc-dec, conv frontend stubbed
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

WHISPER_MEDIUM = register(ModelConfig(
    name="whisper-medium", family="whisper", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    n_enc_layers=24, n_frames=1500, norm_eps=1e-5,
    skip_shapes=_FULL_ATTN_SKIP))
