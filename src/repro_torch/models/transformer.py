"""Dense GQA transformer LM (qwen/yi/internlm families).

Functional over a flat parameter dict with the reference's path keys
(`"layers/wq"`, …) and stacked `(L, …)` layer weights, so a checkpoint
and the carry-across of reference weights need no renaming. The layer
loop walks `torch.unbind` slices of the stacked weights: indexing
`w[i]` per layer would make each slice's backward allocate a zero tensor
of the whole stack.

Remat policies map as follows: "none" is plain autograd; "full"
recomputes each layer in the backward
(`torch.utils.checkpoint.checkpoint`, non-reentrant); "dots" saves the
matrix products with no batch dims (`aten.mm`/`aten.addmm`) and
recomputes the rest, the counterpart of the reference's
`dots_with_no_batch_dims_saveable`.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decoder import _not_in_slice
from repro_torch.models import common as cm

REMAT_POLICIES = ("none", "full", "dots")


class DenseLM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> cm.ParamDefs:
        c = self.cfg
        L, E, Q, KVD, F, V = (c.n_layers, c.d_model, c.q_dim, c.kv_dim,
                              c.d_ff, c.vocab)
        defs: cm.ParamDefs = {
            "embed": ((V, E), ("vocab", "embed")),
            "final_norm": ((E,), (None,)),
            "unembed": ((E, V), ("embed", "vocab")),
            "layers/attn_norm": ((L, E), ("layers", None)),
            "layers/mlp_norm": ((L, E), ("layers", None)),
            "layers/wq": ((L, E, Q), ("layers", "embed", "heads")),
            "layers/wk": ((L, E, KVD), ("layers", "embed", "kv_heads")),
            "layers/wv": ((L, E, KVD), ("layers", "embed", "kv_heads")),
            "layers/wo": ((L, Q, E), ("layers", "heads", "embed")),
            "layers/w_gate": ((L, E, F), ("layers", "embed", "ffn")),
            "layers/w_up": ((L, E, F), ("layers", "embed", "ffn")),
            "layers/w_down": ((L, F, E), ("layers", "ffn", "embed")),
        }
        if c.qkv_bias:
            defs["layers/bq"] = ((L, Q), ("layers", "heads"))
            defs["layers/bk"] = ((L, KVD), ("layers", "kv_heads"))
            defs["layers/bv"] = ((L, KVD), ("layers", "kv_heads"))
        return defs

    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        return cm.init_params(self.param_defs(), generator, dtype)

    # ------------------------------------------------------------ sublayers
    def _qkv(self, lp, h, positions):
        c = self.cfg
        B, S, _ = h.shape
        q = cm._mm(h, lp["wq"])
        k = cm._mm(h, lp["wk"])
        v = cm._mm(h, lp["wv"])
        if c.qkv_bias:
            q = q + lp["bq"]
            k = k + lp["bk"]
            v = v + lp["bv"]
        q = q.reshape(B, S, c.n_heads, c.head_dim)
        k = k.reshape(B, S, c.n_kv_heads, c.head_dim)
        v = v.reshape(B, S, c.n_kv_heads, c.head_dim)
        q = cm.apply_rope(q, positions, c.rope_theta)
        k = cm.apply_rope(k, positions, c.rope_theta)
        return q, k, v

    def _mlp(self, lp, h):
        return cm.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _block(self, lp, h, positions, window: int = 0):
        c = self.cfg
        hn = cm.rms_norm(h, lp["attn_norm"], c.norm_eps)
        q, k, v = self._qkv(lp, hn, positions)
        att = cm.gqa_attention(q, k, v, causal=True, window=window)
        att = att.reshape(h.shape[0], h.shape[1], c.q_dim)
        h = h + cm._mm(att, lp["wo"])
        hn = cm.rms_norm(h, lp["mlp_norm"], c.norm_eps)
        return h + self._mlp(lp, hn)

    # -------------------------------------------------------------- forward
    def forward(self, params: Dict, tokens, mrope=None, img_embeds=None,
                remat: str = "full", collect_kv: bool = False):
        if mrope is not None or img_embeds is not None:
            raise _not_in_slice("DenseLM mrope/img_embeds (the VLM)",
                                "remaining-models")
        if collect_kv:
            raise _not_in_slice("DenseLM KV collection", "model-serving")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat!r}")
        c = self.cfg
        B, S = tokens.shape
        h = torch.nn.functional.embedding(
            tokens, params["embed"].to(torch.bfloat16))
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        names = sorted(k.split("/", 1)[1] for k in params
                       if k.startswith("layers/"))
        stacks = [torch.unbind(params[f"layers/{n}"], 0) for n in names]
        for layer in zip(*stacks):
            lp = dict(zip(names, layer))
            h = _run_layer(functools.partial(self._block, lp,
                                             positions=positions), h, remat)
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        return cm._mm(h, params["unembed"])

    def loss(self, params: Dict, batch: Dict, remat: str = "full"):
        logits = self.forward(params, batch["tokens"],
                              mrope=batch.get("mrope"),
                              img_embeds=batch.get("img_embeds"),
                              remat=remat)
        return cm.cross_entropy_loss(logits, batch["labels"], self.cfg.vocab)

    # -------------------------------------------------------------- serving
    def init_cache(self, *args, **kwargs):
        raise _not_in_slice("DenseLM.init_cache (the KV cache)",
                            "model-serving")

    def decode_step(self, *args, **kwargs):
        raise _not_in_slice("DenseLM.decode_step", "model-serving")


def _save_dots(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(fn, h, remat: str):
    if remat == "none" or not torch.is_grad_enabled():
        return fn(h)
    if remat == "full":
        return checkpoint(fn, h, use_reentrant=False)
    return checkpoint(fn, h, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _save_dots))
