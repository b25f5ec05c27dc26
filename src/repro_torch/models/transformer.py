"""Dense GQA transformer LM (qwen/yi/internlm families; backbone for the
VLM and the attention half of the MoE models).

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

Serving: `decode_step` runs one token a sequence against a KV cache
(`init_cache`, `(L, B, S, KV, D)` keys after RoPE and values, and the
(B,) position). It writes the cache in place, at a slot clamped into
[0, S-1] on the device as the reference's `dynamic_update_slice` clamps
it, so a step never waits for the device.

`mrope` (3, B, S) t/h/w position ids replace RoPE by M-RoPE, and
`img_embeds` (B, n_img, E) overwrite the embeddings of positions
[0, n_img): the VLM's inputs (`models/vlm.py`). `input_specs` and
`input_axes` give a shape's inputs as meta tensors and logical axes.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.decoder import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models import common as cm

REMAT_POLICIES = ("none", "full", "dots")


def check_remat(remat: str) -> None:
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}")


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
    def _qkv(self, lp, h, positions, mrope=None):
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
        if mrope is not None:
            q = cm.apply_mrope(q, mrope, c.rope_theta, c.mrope_sections)
            k = cm.apply_mrope(k, mrope, c.rope_theta, c.mrope_sections)
        else:
            q = cm.apply_rope(q, positions, c.rope_theta)
            k = cm.apply_rope(k, positions, c.rope_theta)
        # the reference's sequence-parallel attention: q sharded on Sq
        # over "model", the small GQA k/v replicated (no-ops off a mesh)
        if S > 1:
            q = shard(q, ("batch", "kv_seq", None, None))
        k = shard(k, ("batch", None, None, None))
        v = shard(v, ("batch", None, None, None))
        return q, k, v

    def _mlp(self, lp, h):
        return cm.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])

    def _block(self, lp, h, positions, mrope=None, window: int = 0):
        c = self.cfg
        hn = cm.rms_norm(h, lp["attn_norm"], c.norm_eps)
        q, k, v = self._qkv(lp, hn, positions, mrope)
        att = cm.gqa_attention(q, k, v, causal=True, window=window)
        att = shard(att, ("batch", "kv_seq", None, None))
        att = att.reshape(h.shape[0], h.shape[1], c.q_dim)
        h = h + cm._mm(att, lp["wo"])
        h = shard(h, ("batch", "seq", "embed_act"))
        hn = cm.rms_norm(h, lp["mlp_norm"], c.norm_eps)
        return shard(h + self._mlp(lp, hn), ("batch", "seq", "embed_act")), \
            (k, v)

    def _layers(self, params: Dict):
        """Per-layer weight dicts: `torch.unbind` views of the stacks."""
        return cm.unstack(cm.subtree(params, "layers"))

    # -------------------------------------------------------------- forward
    def forward(self, params: Dict, tokens, mrope=None, img_embeds=None,
                remat: str = "full", collect_kv: bool = False):
        check_remat(remat)
        c = self.cfg
        B, S = tokens.shape
        h = torch.nn.functional.embedding(
            tokens, params["embed"].to(torch.bfloat16))
        if img_embeds is not None:
            # the reference's dynamic_update_slice at (0, 0, 0)
            n = img_embeds.shape[1]
            if n > S:
                raise ValueError(f"{n} image embeddings do not fit in a "
                                 f"sequence of {S}")
            h = torch.cat([img_embeds.to(h.dtype), h[:, n:]], dim=1)
        h = shard(h, ("batch", "seq", "embed_act"))
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        ks, vs = [], []
        for lp in self._layers(params):
            h, (k, v) = _run_layer(functools.partial(
                self._block, lp, positions=positions, mrope=mrope), h, remat)
            if collect_kv:
                ks.append(k)
                vs.append(v)
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        logits = shard(cm._mm(h, params["unembed"]), ("batch", "seq", "vocab"))
        if collect_kv:
            return logits, (torch.stack(ks), torch.stack(vs))
        return logits

    def loss(self, params: Dict, batch: Dict, remat: str = "full"):
        logits = self.forward(params, batch["tokens"],
                              mrope=batch.get("mrope"),
                              img_embeds=batch.get("img_embeds"),
                              remat=remat)
        return cm.cross_entropy_loss(logits, batch["labels"], self.cfg.vocab)

    # -------------------------------------------------------------- serving
    def cache_specs(self, B: int, S: int, dtype=torch.bfloat16):
        c = self.cfg
        return cm.kv_cache_specs(B, S, c.n_kv_heads, c.head_dim, c.n_layers,
                                 dtype)

    def cache_axes(self):
        return dict(cm.KV_CACHE_AXES)

    def init_cache(self, B: int, S: int, dtype=torch.bfloat16,
                   device="cuda"):
        c = self.cfg
        return cm.init_kv_cache(B, S, c.n_kv_heads, c.head_dim, c.n_layers,
                                dtype, resolve_device(device))

    def decode_step(self, params: Dict, cache: Dict, tokens, mrope=None):
        """One token per sequence: tokens (B, 1) → logits (B, vocab).
        Writes the new keys and values into `cache` in place and returns
        it with `pos` advanced by one."""
        c = self.cfg
        B = tokens.shape[0]
        h = torch.nn.functional.embedding(
            tokens, params["embed"].to(torch.bfloat16))          # (B,1,E)
        pos = cache["pos"]                                       # (B,)
        positions = pos[:, None]
        # the write slot of every row is pos[0], clamped into the cache
        # as dynamic_update_slice clamps its start: a device index, so
        # the host never waits for pos
        slot = pos[:1].clamp(0, cache["k"].shape[2] - 1).long()
        kv_len = pos + 1
        for i, lp in enumerate(self._layers(params)):
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            hn = cm.rms_norm(h, lp["attn_norm"], c.norm_eps)
            q, k, v = self._qkv(lp, hn, positions, mrope)
            # keys cached post-rope → ring/linear layout agnostic
            k_cache.index_copy_(1, slot, k)
            v_cache.index_copy_(1, slot, v)
            att = cm.gqa_attention(q, k_cache, v_cache, causal=False,
                                   kv_len=kv_len)
            att = att.reshape(B, 1, c.q_dim)
            h = h + cm._mm(att, lp["wo"])
            hn = cm.rms_norm(h, lp["mlp_norm"], c.norm_eps)
            h = h + self._mlp(lp, hn)
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        logits = cm._mm(h, params["unembed"])[:, 0]
        cache["pos"] = kv_len
        return logits, cache

    # -------------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict:
        """The inputs of `shape` as meta tensors."""
        return token_specs(shape)

    def input_axes(self, shape: ShapeConfig) -> Dict:
        return token_axes(shape, self.input_specs(shape))


def token_specs(shape: ShapeConfig) -> Dict:
    """Token (and label) inputs of a train, prefill or decode shape."""
    B, S = shape.global_batch, shape.seq_len
    tok = cm.meta((B, S), torch.int32)
    if shape.kind == "train":
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        return {"tokens": tok}
    return {"tokens": cm.meta((B, 1), torch.int32)}


def token_axes(shape: ShapeConfig, specs: Dict, **extra) -> Dict:
    """Logical axes of the inputs in `specs`: tokens and labels, and the
    `extra` inputs a family adds."""
    ax = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), **extra}
    if shape.kind == "decode":
        ax["tokens"] = ("batch", None)
    return {k: v for k, v in ax.items() if k in specs}


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
