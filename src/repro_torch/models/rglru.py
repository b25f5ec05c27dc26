"""RecurrentGemma (arXiv:2402.19427): RG-LRU recurrent blocks + local
sliding-window attention, pattern (rec, rec, attn).

The RG-LRU linear recurrence h_t = a_t·h_{t-1} + b_t trains with a
log-depth doubling scan over the time axis, ⌈log2 T⌉ rounds of
elementwise ops (the reference uses `jax.lax.associative_scan`, also
log-depth; the two trees round differently, within fp32 rounding).
Decode keeps O(1) recurrent state plus a `local_window` KV ring (keys
cached post-RoPE, so ring order does not matter): slot `pos mod W`,
`kv_len = min(pos + 1, W)`, both on the device.

26 layers = 8 (rec, rec, attn) groups, stacked `(G, RPG, …)` for the
recurrent and `(G, …)` for the attention layers, + 2 trailing rec
layers (`tail/…`, `(T, …)`). Plain PyTorch: the reference has no
Pallas kernel here.
"""
from __future__ import annotations

import functools
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

_C = 8.0  # RG-LRU decay sharpness constant


# ------------------------------------------------------------------ RG-LRU
def _coeffs(x, r_gate, i_gate, lam):
    """a_t and b_t of h_t = a_t·h_{t-1} + b_t (lam broadcast to x)."""
    a_log = -_C * F.softplus(lam) * r_gate                       # <= 0
    a = torch.exp(a_log)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * a_log), min=1e-6)) \
        * (i_gate * x)
    return a, b


def rglru_scan(x, r_gate, i_gate, lam):
    """x (B,S,R) fp32; gates (B,S,R); lam (R,) raw. Doubling scan: after
    the round of stride d, (a_t, b_t) composes steps (t-2d, t]; the
    composition of (a_l, b_l) then (a_r, b_r) is (a_l·a_r, b_l·a_r + b_r),
    the reference's `combine`, and steps before 0 are (1, 0)."""
    a, b = _coeffs(x, r_gate, i_gate, lam[None, None, :])
    S = a.shape[1]
    d = 1
    while d < S:
        a_l = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_l = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = a_l * a, b_l * a + b
        d *= 2
    return b


def rglru_step(x, r_gate, i_gate, lam, h_prev):
    a, b = _coeffs(x, r_gate, i_gate, lam[None, :])
    return a * h_prev + b


def causal_conv4(x, kern, state=None):
    """Depthwise causal conv, width 4. x (B,S,R), kern (4,R).
    state (B,3,R) holds the previous 3 inputs for decode, cast to x's
    dtype (the cache keeps fp32)."""
    if state is None:
        pad = torch.zeros((x.shape[0], 3, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    L = xp.shape[1]
    out = 0
    for i in range(4):
        out = out + xp[:, 3 - i:L - i] * kern[3 - i][None, None]
    return out, xp[:, -3:]


class RecurrentGemma(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        pat = len(cfg.layer_pattern)                     # 3: (rec, rec, attn)
        self.n_groups = cfg.n_layers // pat              # stacked groups
        self.n_tail = cfg.n_layers - self.n_groups * pat  # trailing rec
        self.rec_per_group = sum(1 for p in cfg.layer_pattern if p == "rec")

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> cm.ParamDefs:
        c = self.cfg
        G, RPG, T = self.n_groups, self.rec_per_group, self.n_tail
        E, V, F_ = c.d_model, c.vocab, c.d_ff
        R = E                                            # lru width
        Q, KVD = c.q_dim, c.kv_dim

        def rec_defs(prefix, lead):
            ax = ("layers", None)[:len(lead)]
            return {
                f"{prefix}/norm": (lead + (E,), ax + (None,)),
                f"{prefix}/w_x": (lead + (E, R), ax + ("embed", "ffn")),
                f"{prefix}/w_y": (lead + (E, R), ax + ("embed", "ffn")),
                f"{prefix}/conv": (lead + (4, R), ax + (None, "ffn")),
                f"{prefix}/w_r": (lead + (R, R), ax + ("embed", "ffn")),
                f"{prefix}/w_i": (lead + (R, R), ax + ("embed", "ffn")),
                f"{prefix}/lam": (lead + (R,), ax + ("ffn",)),
                f"{prefix}/w_out": (lead + (R, E), ax + ("ffn", "embed")),
                f"{prefix}/mlp_norm": (lead + (E,), ax + (None,)),
                f"{prefix}/w_gate": (lead + (E, F_), ax + ("embed", "ffn")),
                f"{prefix}/w_up": (lead + (E, F_), ax + ("embed", "ffn")),
                f"{prefix}/w_down": (lead + (F_, E), ax + ("ffn", "embed")),
            }

        defs: cm.ParamDefs = {
            "embed": ((V, E), ("vocab", "embed")),
            "final_norm": ((E,), (None,)),
            "unembed": ((E, V), ("embed", "vocab")),
            # attention layer of each group
            "attn/norm": ((G, E), ("layers", None)),
            "attn/wq": ((G, E, Q), ("layers", "embed", "heads")),
            "attn/wk": ((G, E, KVD), ("layers", "embed", "kv_heads")),
            "attn/wv": ((G, E, KVD), ("layers", "embed", "kv_heads")),
            "attn/wo": ((G, Q, E), ("layers", "heads", "embed")),
            "attn/mlp_norm": ((G, E), ("layers", None)),
            "attn/w_gate": ((G, E, F_), ("layers", "embed", "ffn")),
            "attn/w_up": ((G, E, F_), ("layers", "embed", "ffn")),
            "attn/w_down": ((G, F_, E), ("layers", "ffn", "embed")),
        }
        defs.update(rec_defs("rec", (G, RPG)))
        if T:
            defs.update(rec_defs("tail", (T,)))
        return defs

    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        p = cm.init_params(self.param_defs(), generator, dtype)
        # lambda init so decay a ∈ [0.9, 0.999] at r=0.5 (paper init)
        for k in p:
            if k.endswith("/lam"):
                p[k].fill_(0.65)
        return p

    # -------------------------------------------------------------- blocks
    def _rec_block(self, rp, h, conv_state=None, lru_state=None,
                   step=False):
        c = self.cfg
        hn = cm.rms_norm(h, rp["norm"], c.norm_eps)
        x = cm._mm(hn, rp["w_x"])
        y = cm._mm(hn, rp["w_y"])
        x, conv_new = causal_conv4(x, rp["conv"], conv_state)
        xf = cm._f32(x)
        r = torch.sigmoid(xf @ cm._f32(rp["w_r"]))
        i = torch.sigmoid(xf @ cm._f32(rp["w_i"]))
        lam = cm._f32(rp["lam"])
        if step:
            hr = rglru_step(xf[:, 0], r[:, 0], i[:, 0], lam, lru_state)
            lru_new = hr
            hr = hr[:, None]
        else:
            hr = rglru_scan(xf, r, i, lam)
            lru_new = hr[:, -1]
        hr = hr.to(h.dtype) * F.gelu(cm._f32(y),
                                     approximate="tanh").to(h.dtype)
        h = h + cm._mm(hr, rp["w_out"])
        hn = cm.rms_norm(h, rp["mlp_norm"], c.norm_eps)
        h = h + cm.swiglu(hn, rp["w_gate"], rp["w_up"], rp["w_down"])
        return h, conv_new, lru_new

    def _attn_block(self, ap, h, positions, k_cache=None, v_cache=None,
                    pos=None):
        c = self.cfg
        B, S, _ = h.shape
        hn = cm.rms_norm(h, ap["norm"], c.norm_eps)
        q = cm._mm(hn, ap["wq"]).reshape(B, S, c.n_heads, c.head_dim)
        k = cm._mm(hn, ap["wk"]).reshape(B, S, c.n_kv_heads, c.head_dim)
        v = cm._mm(hn, ap["wv"]).reshape(B, S, c.n_kv_heads, c.head_dim)
        q = cm.apply_rope(q, positions, c.rope_theta)
        k = cm.apply_rope(k, positions, c.rope_theta)
        if k_cache is None:
            # the reference's sequence-parallel local attention (no-ops
            # off a mesh)
            if S > 1:
                q = shard(q, ("batch", "kv_seq", None, None))
                k = shard(k, ("batch", None, None, None))
                v = shard(v, ("batch", None, None, None))
            att = cm.gqa_attention(q, k, v, causal=True,
                                   window=c.local_window)
            if S > 1:
                att = shard(att, ("batch", "kv_seq", None, None))
        else:
            # the ring: slot pos mod W, written in place on the device
            W = k_cache.shape[1]
            slot = torch.remainder(pos[:1], W).long()
            k_cache.index_copy_(1, slot, k)
            v_cache.index_copy_(1, slot, v)
            live = torch.clamp(pos + 1, max=W)
            att = cm.gqa_attention(q, k_cache, v_cache, causal=False,
                                   kv_len=live)
        att = att.reshape(B, S, c.q_dim)
        h = h + cm._mm(att, ap["wo"])
        hn = cm.rms_norm(h, ap["mlp_norm"], c.norm_eps)
        return h + cm.swiglu(hn, ap["w_gate"], ap["w_up"], ap["w_down"])

    def _group(self, rp_g, ap, positions, h):
        for rp in cm.unstack(rp_g):
            h = self._rec_block(rp, h)[0]
        return shard(self._attn_block(ap, h, positions),
                     ("batch", "seq", "embed_act"))

    # -------------------------------------------------------------- forward
    def forward(self, params: Dict, tokens, remat: str = "full"):
        check_remat(remat)
        c = self.cfg
        S = tokens.shape[1]
        h = F.embedding(tokens, params["embed"].to(torch.bfloat16))
        h = shard(h, ("batch", "seq", "embed_act"))
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
        groups = zip(cm.unstack(cm.subtree(params, "rec")),
                     cm.unstack(cm.subtree(params, "attn")))
        for rp_g, ap in groups:
            h = _run_layer(functools.partial(self._group, rp_g, ap,
                                             positions), h, remat)
        for rp in cm.unstack(cm.subtree(params, "tail")):
            h = self._rec_block(rp, h)[0]
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        return shard(cm._mm(h, params["unembed"]), ("batch", "seq", "vocab"))

    def loss(self, params, batch, remat: str = "full"):
        logits = self.forward(params, batch["tokens"], remat=remat)
        return cm.cross_entropy_loss(logits, batch["labels"], self.cfg.vocab)

    # -------------------------------------------------------------- serving
    def cache_specs(self, B: int, S: int, dtype=torch.bfloat16):
        c = self.cfg
        G, RPG, T = self.n_groups, self.rec_per_group, self.n_tail
        R = c.d_model
        W = min(c.local_window, S)
        f32 = torch.float32
        spec = {
            "rec_lru": cm.meta((G, RPG, B, R), f32),
            "rec_conv": cm.meta((G, RPG, B, 3, R), f32),
            "k": cm.meta((G, B, W, c.n_kv_heads, c.head_dim), dtype),
            "v": cm.meta((G, B, W, c.n_kv_heads, c.head_dim), dtype),
            "pos": cm.meta((B,), torch.int32),
        }
        if T:
            spec["tail_lru"] = cm.meta((T, B, R), f32)
            spec["tail_conv"] = cm.meta((T, B, 3, R), f32)
        return spec

    def cache_axes(self):
        ax = {
            "rec_lru": ("layers", None, "batch", "ffn"),
            "rec_conv": ("layers", None, "batch", None, "ffn"),
            "k": ("layers", "batch", "kv_seq", None, None),
            "v": ("layers", "batch", "kv_seq", None, None),
            "pos": ("batch",),
        }
        if self.n_tail:
            ax["tail_lru"] = ("layers", "batch", "ffn")
            ax["tail_conv"] = ("layers", "batch", None, "ffn")
        return ax

    def init_cache(self, B: int, S: int, dtype=torch.bfloat16,
                   device="cuda"):
        return cm.zeros_like_specs(self.cache_specs(B, S, dtype),
                                   resolve_device(device))

    def _rec_step(self, rp, h, lru, conv):
        """One decode step of a recurrent layer; its states (views of the
        cache) are written in place."""
        h, conv_n, lru_n = self._rec_block(rp, h, conv_state=conv,
                                           lru_state=lru, step=True)
        lru.copy_(lru_n)
        conv.copy_(conv_n)
        return h

    def decode_step(self, params: Dict, cache: Dict, tokens):
        """tokens (B, 1) → logits (B, vocab); the recurrent states and
        the attention rings are updated in place, `pos` advanced."""
        c = self.cfg
        pos = cache["pos"]
        h = F.embedding(tokens, params["embed"].to(torch.bfloat16))
        positions = pos[:, None]
        groups = zip(cm.unstack(cm.subtree(params, "rec")),
                     cm.unstack(cm.subtree(params, "attn")))
        for g, (rp_g, ap) in enumerate(groups):
            for r, rp in enumerate(cm.unstack(rp_g)):
                h = self._rec_step(rp, h, cache["rec_lru"][g, r],
                                   cache["rec_conv"][g, r])
            h = self._attn_block(ap, h, positions, k_cache=cache["k"][g],
                                 v_cache=cache["v"][g], pos=pos)
        for t, rp in enumerate(cm.unstack(cm.subtree(params, "tail"))):
            h = self._rec_step(rp, h, cache["tail_lru"][t],
                               cache["tail_conv"][t])
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        logits = cm._mm(h, params["unembed"])[:, 0]
        cache["pos"] = pos + 1
        return logits, cache

    # -------------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict:
        return token_specs(shape)

    def input_axes(self, shape: ShapeConfig) -> Dict:
        return token_axes(shape, self.input_specs(shape))
