"""Whisper-medium backbone (arXiv:2212.04356): encoder-decoder transformer.

The conv audio frontend is a stub, as in the JAX package: `input_specs()`
supplies precomputed frame embeddings (B, n_frames, d), and the
transformer backbone (24 enc + 24 dec layers, LayerNorm + GELU,
non-causal encoder self-attention, cross-attention) is complete.
Positions are sinusoidal on both sides, added in bf16; the output
projection is the tied embedding.

Serving: `init_cache` holds the decoder's self-attention K/V and the
cross-attention K/V of every decoder layer. The cross K/V are primed
from the encoder only when `params` and `frames` are given; otherwise
they stay zero, as the reference's do (so a decoder served by
`ServeSession`, which passes neither, attends to zero frames).
"""
from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.decoder import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models import common as cm
from repro_torch.models.transformer import (_run_layer, check_remat,
                                            token_axes, token_specs)


def sinusoid_pos(S: int, E: int, offset=0, device=None):
    """(S, E) fp32 sinusoids of positions offset..offset+S-1; `offset`
    may be a device tensor of one element (the decode position)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
    p = torch.arange(S, device=device) + offset
    half = E // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=device)
                      / max(half - 1, 1))
    ang = p[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class Whisper(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> cm.ParamDefs:
        c = self.cfg
        Le, Ld = c.n_enc_layers, c.n_layers
        E, Q, F_, V = c.d_model, c.q_dim, c.d_ff, c.vocab

        def attn(prefix, L):
            return {
                f"{prefix}/norm_w": ((L, E), ("layers", None)),
                f"{prefix}/norm_b": ((L, E), ("layers", None)),
                f"{prefix}/wq": ((L, E, Q), ("layers", "embed", "heads")),
                f"{prefix}/wk": ((L, E, Q), ("layers", "embed", "heads")),
                f"{prefix}/wv": ((L, E, Q), ("layers", "embed", "heads")),
                f"{prefix}/wo": ((L, Q, E), ("layers", "heads", "embed")),
            }

        def mlp(prefix, L):
            return {
                f"{prefix}/norm_w": ((L, E), ("layers", None)),
                f"{prefix}/norm_b": ((L, E), ("layers", None)),
                f"{prefix}/w_in": ((L, E, F_), ("layers", "embed", "ffn")),
                f"{prefix}/b_in": ((L, F_), ("layers", "ffn")),
                f"{prefix}/w_out": ((L, F_, E), ("layers", "ffn", "embed")),
                f"{prefix}/b_out": ((L, E), ("layers", None)),
            }

        defs: cm.ParamDefs = {
            "embed": ((V, E), ("vocab", "embed")),
            "enc_final_w": ((E,), (None,)),
            "enc_final_b": ((E,), (None,)),
            "dec_final_w": ((E,), (None,)),
            "dec_final_b": ((E,), (None,)),
        }
        defs.update(attn("enc/self", Le))
        defs.update(mlp("enc/mlp", Le))
        defs.update(attn("dec/self", Ld))
        defs.update(attn("dec/cross", Ld))
        defs.update(mlp("dec/mlp", Ld))
        return defs

    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        return cm.init_params(self.param_defs(), generator, dtype)

    # -------------------------------------------------------------- helpers
    def _heads(self, x):
        c = self.cfg
        return x.reshape(x.shape[0], x.shape[1], c.n_heads, c.head_dim)

    def _proj_qkv(self, lp, hq, hkv):
        return (self._heads(cm._mm(hq, lp["wq"])),
                self._heads(cm._mm(hkv, lp["wk"])),
                self._heads(cm._mm(hkv, lp["wv"])))

    def _out(self, lp, h, att):
        return h + cm._mm(att.reshape(h.shape[0], h.shape[1], -1), lp["wo"])

    def _mlp(self, mp, h):
        hn = cm.layer_norm(h, mp["norm_w"], mp["norm_b"], self.cfg.norm_eps)
        return h + cm.gelu_mlp(hn, mp["w_in"], mp["b_in"], mp["w_out"],
                               mp["b_out"])

    def _ln(self, lp, h):
        return cm.layer_norm(h, lp["norm_w"], lp["norm_b"], self.cfg.norm_eps)

    def _enc_layer(self, sp, mp, h):
        hn = self._ln(sp, h)
        q, k, v = self._proj_qkv(sp, hn, hn)
        h = self._out(sp, h, cm.gqa_attention(q, k, v, causal=False))
        return self._mlp(mp, h)

    def _dec_layer(self, sp, xp, mp, enc_out, h):
        hn = self._ln(sp, h)
        q, k, v = self._proj_qkv(sp, hn, hn)
        h = self._out(sp, h, cm.gqa_attention(q, k, v, causal=True))
        q, k, v = self._proj_qkv(xp, self._ln(xp, h), enc_out)
        h = self._out(xp, h, cm.cross_attention(q, k, v))
        return self._mlp(mp, h)

    def encode(self, params: Dict, frames, remat: str = "full"):
        """frames (B, n_frames, E) — stub conv-frontend output."""
        check_remat(remat)
        c = self.cfg
        S, E = frames.shape[1], frames.shape[2]
        h = (frames.to(torch.bfloat16)
             + sinusoid_pos(S, E, device=frames.device)[None]
             .to(torch.bfloat16))
        h = shard(h, ("batch", "frames", "embed_act"))
        for sp, mp in zip(cm.unstack(cm.subtree(params, "enc/self")),
                          cm.unstack(cm.subtree(params, "enc/mlp"))):
            h = _run_layer(functools.partial(self._enc_layer, sp, mp), h,
                           remat)
        return cm.layer_norm(h, params["enc_final_w"], params["enc_final_b"],
                             c.norm_eps)

    def decode(self, params: Dict, tokens, enc_out, remat: str = "full"):
        check_remat(remat)
        c = self.cfg
        S = tokens.shape[1]
        h = (F.embedding(tokens, params["embed"].to(torch.bfloat16))
             + sinusoid_pos(S, c.d_model, device=tokens.device)[None]
             .to(torch.bfloat16))
        h = shard(h, ("batch", "seq", "embed_act"))
        for sp, xp, mp in zip(cm.unstack(cm.subtree(params, "dec/self")),
                              cm.unstack(cm.subtree(params, "dec/cross")),
                              cm.unstack(cm.subtree(params, "dec/mlp"))):
            h = _run_layer(functools.partial(self._dec_layer, sp, xp, mp,
                                             enc_out), h, remat)
        h = cm.layer_norm(h, params["dec_final_w"], params["dec_final_b"],
                          c.norm_eps)
        logits = cm._mm(h, params["embed"].T)                    # tied
        return shard(logits, ("batch", "seq", "vocab"))

    def forward(self, params, tokens, frames=None, remat: str = "full"):
        enc = self.encode(params, frames, remat=remat)
        return self.decode(params, tokens, enc, remat=remat)

    def loss(self, params, batch, remat: str = "full"):
        logits = self.forward(params, batch["tokens"], batch["frames"],
                              remat=remat)
        return cm.cross_entropy_loss(logits, batch["labels"], self.cfg.vocab)

    # -------------------------------------------------------------- serving
    def cache_specs(self, B: int, S: int, dtype=torch.bfloat16):
        c = self.cfg
        Ld, H, D = c.n_layers, c.n_heads, c.head_dim
        return {
            "k": cm.meta((Ld, B, S, H, D), dtype),
            "v": cm.meta((Ld, B, S, H, D), dtype),
            "xk": cm.meta((Ld, B, c.n_frames, H, D), dtype),
            "xv": cm.meta((Ld, B, c.n_frames, H, D), dtype),
            "pos": cm.meta((B,), torch.int32),
        }

    def cache_axes(self):
        kv = ("layers", "batch", "kv_seq", None, None)
        return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": ("batch",)}

    def init_cache(self, B: int, S: int, dtype=torch.bfloat16,
                   params=None, frames=None, device="cuda"):
        dev = resolve_device(device)
        cache = cm.zeros_like_specs(self.cache_specs(B, S, dtype), dev)
        if params is not None and frames is not None:
            with torch.no_grad():
                enc = self.encode(params, frames, remat="none")
                cross = cm.unstack(cm.subtree(params, "dec/cross"))
                for name, w in (("xk", "wk"), ("xv", "wv")):
                    cache[name] = torch.stack(
                        [self._heads(cm._mm(enc, p[w])) for p in cross]
                    ).to(dtype=dtype, device=dev)
        return cache

    def decode_step(self, params: Dict, cache: Dict, tokens):
        """tokens (B, 1) → logits (B, vocab); the self-attention K/V are
        written in place at `pos` (clamped into the cache, as the
        reference's `dynamic_update_slice` clamps), `pos` advanced."""
        c = self.cfg
        pos = cache["pos"]
        h = (F.embedding(tokens, params["embed"].to(torch.bfloat16))
             + sinusoid_pos(1, c.d_model, offset=pos[:1])[None]
             .to(torch.bfloat16))
        slot = pos[:1].clamp(0, cache["k"].shape[2] - 1).long()
        kv_len = pos + 1
        layers = zip(cm.unstack(cm.subtree(params, "dec/self")),
                     cm.unstack(cm.subtree(params, "dec/cross")),
                     cm.unstack(cm.subtree(params, "dec/mlp")))
        for i, (sp, xp, mp) in enumerate(layers):
            k_c, v_c = cache["k"][i], cache["v"][i]
            hn = self._ln(sp, h)
            q, k, v = self._proj_qkv(sp, hn, hn)
            k_c.index_copy_(1, slot, k)
            v_c.index_copy_(1, slot, v)
            h = self._out(sp, h, cm.gqa_attention(q, k_c, v_c, causal=False,
                                                  kv_len=kv_len))
            q = self._heads(cm._mm(self._ln(xp, h), xp["wq"]))
            h = self._out(xp, h, cm.cross_attention(q, cache["xk"][i],
                                                    cache["xv"][i]))
            h = self._mlp(mp, h)
        h = cm.layer_norm(h, params["dec_final_w"], params["dec_final_b"],
                          c.norm_eps)
        logits = cm._mm(h, params["embed"].T)[:, 0]
        cache["pos"] = kv_len
        return logits, cache

    # -------------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict:
        c = self.cfg
        specs = token_specs(shape)
        if shape.kind != "decode":
            specs["frames"] = cm.meta(
                (shape.global_batch, c.n_frames, c.d_model), torch.float32)
        return specs

    def input_axes(self, shape: ShapeConfig) -> Dict:
        return token_axes(shape, self.input_specs(shape),
                          frames=("batch", "frames", "embed_act"))
