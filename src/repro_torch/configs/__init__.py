"""Assigned architecture configs — one module per arch (exact numbers).

`long_500k` runs only for the sub-quadratic families (xlstm, recurrentgemma);
pure full-attention archs skip it (see DESIGN.md §shape-grid-skips).
"""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, ALL_SHAPES,
                                SHAPES_BY_NAME, TRAIN_4K, PREFILL_32K,
                                DECODE_32K, LONG_500K, register, get_config,
                                all_configs)
from repro_torch.configs.qwen1_5_32b import QWEN15_32B
from repro_torch.configs.yi_6b import YI_6B
from repro_torch.configs.qwen2_1_5b import QWEN2_15B
from repro_torch.configs.internlm2_1_8b import INTERNLM2_18B
from repro_torch.configs.whisper_medium import WHISPER_MEDIUM
from repro_torch.configs.xlstm_350m import XLSTM_350M
from repro_torch.configs.qwen3_moe_235b_a22b import QWEN3_MOE
from repro_torch.configs.grok_1_314b import GROK1
from repro_torch.configs.recurrentgemma_2b import RECURRENTGEMMA_2B
from repro_torch.configs.qwen2_vl_2b import QWEN2_VL_2B

ALL_ARCHS = ("qwen1.5-32b", "yi-6b", "qwen2-1.5b", "internlm2-1.8b",
             "whisper-medium", "xlstm-350m", "qwen3-moe-235b-a22b",
             "grok-1-314b", "recurrentgemma-2b", "qwen2-vl-2b")
