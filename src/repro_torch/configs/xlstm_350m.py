"""Assigned architecture config — exact numbers from the assignment.

# [arXiv:2405.04517; unverified] sLSTM + mLSTM blocks; d_ff=0 → block projections
"""
from repro_torch.configs.base import ModelConfig, register

_FULL_ATTN_SKIP = ("long_500k",)

XLSTM_350M = register(ModelConfig(
    name="xlstm-350m", family="xlstm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, head_dim=256, slstm_every=4,
    sub_quadratic=True))
