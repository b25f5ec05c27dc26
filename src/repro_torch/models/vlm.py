"""Qwen2-VL backbone (arXiv:2409.12191): the qwen2 dense LM with M-RoPE
(t/h/w rotary sections 16/24/24) and a stubbed vision frontend, as in
the JAX package — `input_specs()` supplies precomputed patch embeddings
(B, n_img_tokens, d) which replace the leading token positions, and
M-RoPE position ids (3, B, S) are an input: text tokens carry (t,t,t),
image tokens their (t, h, w) grid coordinates. Without ids, `forward`
and `decode_step` use text-only ids (t = h = w = the position; in
decode, the cache's position, read on the device).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models import common as cm
from repro_torch.models.transformer import DenseLM, token_axes, token_specs


class VLM(DenseLM):
    def forward(self, params, tokens, mrope=None, img_embeds=None,
                remat: str = "full", collect_kv: bool = False):
        if mrope is None:
            # default M-RoPE ids: pure-text positions (t == h == w)
            B, S = tokens.shape
            p = torch.arange(S, dtype=torch.int32, device=tokens.device)
            mrope = p[None, None, :].expand(3, B, S)
        return super().forward(params, tokens, mrope=mrope,
                               img_embeds=img_embeds, remat=remat,
                               collect_kv=collect_kv)

    def decode_step(self, params, cache, tokens, mrope=None):
        if mrope is None:
            B = tokens.shape[0]
            mrope = cache["pos"][None, :, None].expand(3, B, 1)
        return super().decode_step(params, cache, tokens, mrope=mrope)

    # -------------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict:
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        specs = token_specs(shape)
        if shape.kind == "decode":
            return specs
        specs["img_embeds"] = cm.meta((B, c.n_img_tokens, c.d_model),
                                      torch.float32)
        specs["mrope"] = cm.meta((3, B, S), torch.int32)
        return specs

    def input_axes(self, shape: ShapeConfig) -> Dict:
        return token_axes(shape, self.input_specs(shape),
                          img_embeds=("batch", None, "embed_act"),
                          mrope=(None, "batch", "seq"))
