"""xLSTM LM (sLSTM + mLSTM blocks, arXiv:2405.04517).

  mLSTM — chunkwise-parallel matrix-memory form (the linear-attention
          chunking): quadratic only within a chunk, S/W sequential
          steps. fp32 cell arithmetic.
  sLSTM — sequential scalar memory with exponential gating and a max
          stabilizer: one step a token (the paper's own constraint), a
          Python loop here as `lax.scan` is in the reference.

Block pattern: one sLSTM per `slstm_every` blocks, in groups of
(slstm_every-1) mLSTM blocks + 1 sLSTM block; mLSTM weights are stacked
`(G, M, …)`, sLSTM weights `(G, …)`. d_ff=0 ⇒ projections live inside
the blocks (up-factor 2 mLSTM, post-FFN 4/3 sLSTM), as in the JAX
package, which folds away the reference implementation's conv4. Every
exponent is clamped at 30 and the sLSTM stabilizer starts at -30, as
there. Plain PyTorch: the reference has no Pallas kernel here.
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
from repro_torch.models import common as cm
from repro_torch.models.transformer import (_run_layer, check_remat,
                                            token_axes, token_specs)

_CLAMP = 30.0


def _exp(x):
    return torch.exp(torch.clamp(x, max=_CLAMP))


# ------------------------------------------------------------- mLSTM pieces
def mlstm_chunked(q, k, v, i_raw, f_raw, chunk: int = 128, state=None):
    """Chunkwise-parallel mLSTM. q,k,v (B,S,H,D); i_raw,f_raw (B,S,H).
    Returns h (B,S,H,D) and final (C (B,H,D,D), n (B,H,D))."""
    B, S, H, D = q.shape
    W = min(chunk, S)
    assert S % W == 0, "seq must divide by chunk"
    NC = S // W
    qf = (cm._f32(q) / math.sqrt(D)).reshape(B, NC, W, H, D)
    kf = cm._f32(k).reshape(B, NC, W, H, D)
    vf = cm._f32(v).reshape(B, NC, W, H, D)
    li = cm._f32(i_raw).reshape(B, NC, W, H)
    lf = F.logsigmoid(cm._f32(f_raw)).reshape(B, NC, W, H)
    if state is None:
        C_p = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
        n_p = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    else:
        C_p, n_p = state
    causal = torch.tril(torch.ones((W, W), dtype=torch.float32,
                                   device=q.device))
    hs = []
    for ci in range(NC):
        qc, kc, vc = qf[:, ci], kf[:, ci], vf[:, ci]             # (B,W,H,D)
        lic, lfc = li[:, ci], lf[:, ci]                          # (B,W,H)
        b = torch.cumsum(lfc, dim=1)
        # intra-chunk decay/gate matrix A[i,j] = exp(b_i - b_j + li_j), j<=i
        Dm = b[:, :, None, :] - b[:, None, :, :] + lic[:, None, :, :]
        A = _exp(Dm) * causal[None, :, :, None]
        qk = torch.einsum("bihd,bjhd->bijh", qc, kc)
        h_intra = torch.einsum("bijh,bjhd->bihd", A * qk, vc)
        eb = _exp(b)[..., None]                                  # (B,W,H,1)
        h_inter = eb * torch.einsum("bihd,bhde->bihe", qc, C_p)
        n_vec = eb * n_p[:, None] + torch.einsum("bijh,bjhd->bihd", A, kc)
        denom = torch.clamp(torch.abs(torch.einsum(
            "bihd,bihd->bih", qc, n_vec))[..., None], min=1.0)
        hs.append((h_intra + h_inter) / denom)
        # carry update
        bW = b[:, -1, :]                                         # (B,H)
        wj = _exp(bW[:, None] - b + lic)                         # (B,W,H)
        C_p = (_exp(bW)[..., None, None] * C_p
               + torch.einsum("bjhd,bjhe->bhde", wj[..., None] * kc, vc))
        n_p = (_exp(bW)[..., None] * n_p
               + torch.einsum("bjh,bjhd->bhd", wj, kc))
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h.to(q.dtype), (C_p, n_p)


def mlstm_step(q, k, v, i_raw, f_raw, state):
    """Single-token recurrence (decode). q,k,v (B,H,D); gates (B,H)."""
    C_p, n_p = state
    qf = cm._f32(q) / math.sqrt(q.shape[-1])
    kf = cm._f32(k)
    vf = cm._f32(v)
    fp = torch.exp(F.logsigmoid(cm._f32(f_raw)))
    ip = _exp(cm._f32(i_raw))
    C = fp[..., None, None] * C_p + ip[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", kf, vf)
    n = fp[..., None] * n_p + ip[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qf, n))[..., None],
                      min=1.0)
    return (num / den).to(q.dtype), (C, n)


# ------------------------------------------------------------- sLSTM pieces
def slstm_scan(gates, r_weights, state=None):
    """gates (B,S,4,H,D) pre-activations (i,f,z,o); r (4,H,D,D) recurrent.
    Stabilized exponential gating; returns h (B,S,H,D) + final state
    (c, n, m, h)."""
    B, S, _, H, D = gates.shape
    if state is None:
        z = torch.zeros((B, H, D), dtype=torch.float32, device=gates.device)
        c, n, m, h = z, z, torch.full_like(z, -_CLAMP), z
    else:
        c, n, m, h = state
    rw = cm._f32(r_weights)
    hs = []
    for t in range(S):
        gi = cm._f32(gates[:, t]) + torch.einsum("bhd,ghde->bghe", h, rw)
        it, ft, zt, ot = gi.unbind(1)
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * torch.tanh(zt)
        n = fp * n + ip
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(gates.dtype), (c, n, m, h)


class XLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        assert cfg.n_layers % cfg.slstm_every == 0
        self.n_groups = cfg.n_layers // cfg.slstm_every
        self.m_per_group = cfg.slstm_every - 1

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> cm.ParamDefs:
        c = self.cfg
        G, M = self.n_groups, self.m_per_group
        E, V, H = c.d_model, c.vocab, c.n_heads
        U = 2 * E                     # mLSTM up-dim
        Ds = E // H                   # sLSTM head dim
        Fs = (4 * E) // 3             # sLSTM post-FFN
        return {
            "embed": ((V, E), ("vocab", "embed")),
            "final_norm": ((E,), (None,)),
            "unembed": ((E, V), ("embed", "vocab")),
            # mLSTM blocks, stacked (G, M, ...)
            "m/norm": ((G, M, E), ("layers", None, None)),
            "m/w_up": ((G, M, E, 2 * U), ("layers", None, "embed", "ffn")),
            "m/wq": ((G, M, U, U), ("layers", None, "embed", "ffn")),
            "m/wk": ((G, M, U, U), ("layers", None, "embed", "ffn")),
            "m/wv": ((G, M, U, U), ("layers", None, "embed", "ffn")),
            "m/w_if": ((G, M, U, 2 * H), ("layers", None, "embed", None)),
            "m/out_norm": ((G, M, U), ("layers", None, None)),
            "m/w_down": ((G, M, U, E), ("layers", None, "ffn", "embed")),
            # sLSTM blocks, stacked (G, ...)
            "s/norm": ((G, E), ("layers", None)),
            "s/w_gates": ((G, E, 4 * E), ("layers", "embed", "ffn")),
            "s/r_gates": ((G, 4, H, Ds, Ds),
                          ("layers", None, "heads", None, None)),
            "s/out_norm": ((G, E), ("layers", None)),
            "s/ffn_norm": ((G, E), ("layers", None)),
            "s/w_fin": ((G, E, Fs), ("layers", "embed", "ffn")),
            "s/w_fout": ((G, Fs, E), ("layers", "ffn", "embed")),
        }

    def init(self, generator: torch.Generator, dtype=torch.bfloat16):
        return cm.init_params(self.param_defs(), generator, dtype)

    # -------------------------------------------------------------- blocks
    def _m_qkvif(self, mp, h):
        c = self.cfg
        B, S, E = h.shape
        H = c.n_heads
        U = 2 * E
        hn = cm.rms_norm(h, mp["norm"], c.norm_eps)
        z, g = torch.chunk(cm._mm(hn, mp["w_up"]), 2, dim=-1)    # (B,S,U)
        q = cm._mm(z, mp["wq"]).reshape(B, S, H, U // H)
        k = cm._mm(z, mp["wk"]).reshape(B, S, H, U // H)
        v = cm._mm(z, mp["wv"]).reshape(B, S, H, U // H)
        i_raw, f_raw = torch.chunk(cm._mm(z, mp["w_if"]), 2, dim=-1)
        return q, k, v, i_raw, f_raw, g

    def _m_block(self, mp, h, state=None, step=False):
        c = self.cfg
        B, S, E = h.shape
        q, k, v, i_raw, f_raw, g = self._m_qkvif(mp, h)
        if step:
            cell, new_state = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                                         i_raw[:, 0], f_raw[:, 0], state)
            cell = cell[:, None]                                 # (B,1,H,D)
        else:
            cell, new_state = mlstm_chunked(
                q, k, v, i_raw, f_raw, chunk=min(c.mlstm_chunk, S),
                state=state)
        cell = cm.rms_norm(cell.reshape(B, S, 2 * E), mp["out_norm"],
                           c.norm_eps)
        out = cm._mm(cell * F.silu(cm._f32(g)).to(cell.dtype), mp["w_down"])
        return h + out, new_state

    def _s_block(self, sp, h, state=None):
        c = self.cfg
        B, S, E = h.shape
        H = c.n_heads
        hn = cm.rms_norm(h, sp["norm"], c.norm_eps)
        gates = cm._mm(hn, sp["w_gates"]).reshape(B, S, 4, H, E // H)
        cell, new_state = slstm_scan(gates, sp["r_gates"], state)
        cell = cm.rms_norm(cell.reshape(B, S, E), sp["out_norm"], c.norm_eps)
        h = h + cell
        hn = cm.rms_norm(h, sp["ffn_norm"], c.norm_eps)
        f = cm._mm(hn, sp["w_fin"])
        f = F.gelu(cm._f32(f), approximate="tanh").to(h.dtype)
        return h + cm._mm(f, sp["w_fout"]), new_state

    def _group(self, mp_g, sp, h):
        for mp in cm.unstack(mp_g):
            h = self._m_block(mp, h)[0]
        return self._s_block(sp, h)[0]

    # -------------------------------------------------------------- forward
    def forward(self, params: Dict, tokens, remat: str = "full"):
        check_remat(remat)
        c = self.cfg
        h = F.embedding(tokens, params["embed"].to(torch.bfloat16))
        groups = zip(cm.unstack(cm.subtree(params, "m")),
                     cm.unstack(cm.subtree(params, "s")))
        for mp_g, sp in groups:
            h = _run_layer(functools.partial(self._group, mp_g, sp), h,
                           remat)
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        return cm._mm(h, params["unembed"])

    def loss(self, params, batch, remat: str = "full"):
        logits = self.forward(params, batch["tokens"], remat=remat)
        return cm.cross_entropy_loss(logits, batch["labels"], self.cfg.vocab)

    # -------------------------------------------------------------- serving
    def cache_specs(self, B: int, S: int, dtype=torch.bfloat16):
        c = self.cfg
        G, M, H = self.n_groups, self.m_per_group, c.n_heads
        Dm = 2 * c.d_model // H
        Ds = c.d_model // H
        f32 = torch.float32
        return {
            "m_C": cm.meta((G, M, B, H, Dm, Dm), f32),
            "m_n": cm.meta((G, M, B, H, Dm), f32),
            "s_c": cm.meta((G, B, H, Ds), f32),
            "s_n": cm.meta((G, B, H, Ds), f32),
            "s_m": cm.meta((G, B, H, Ds), f32),
            "s_h": cm.meta((G, B, H, Ds), f32),
            "pos": cm.meta((B,), torch.int32),
        }

    def cache_axes(self):
        return {
            "m_C": ("layers", None, "batch", "heads", None, None),
            "m_n": ("layers", None, "batch", "heads", None),
            "s_c": ("layers", "batch", "heads", None),
            "s_n": ("layers", "batch", "heads", None),
            "s_m": ("layers", "batch", "heads", None),
            "s_h": ("layers", "batch", "heads", None),
            "pos": ("batch",),
        }

    def init_cache(self, B: int, S: int, dtype=torch.bfloat16,
                   device="cuda"):
        cache = cm.zeros_like_specs(self.cache_specs(B, S, dtype),
                                    resolve_device(device))
        cache["s_m"].fill_(-_CLAMP)
        return cache

    def decode_step(self, params: Dict, cache: Dict, tokens):
        """tokens (B, 1) → logits (B, vocab); the mLSTM and sLSTM states
        are updated in place, `pos` advanced."""
        c = self.cfg
        h = F.embedding(tokens, params["embed"].to(torch.bfloat16))
        groups = zip(cm.unstack(cm.subtree(params, "m")),
                     cm.unstack(cm.subtree(params, "s")))
        s_keys = ("s_c", "s_n", "s_m", "s_h")
        for g, (mp_g, sp) in enumerate(groups):
            for i, mp in enumerate(cm.unstack(mp_g)):
                C_p, n_p = cache["m_C"][g, i], cache["m_n"][g, i]
                h, (C_n, n_n) = self._m_block(mp, h, state=(C_p, n_p),
                                              step=True)
                C_p.copy_(C_n)
                n_p.copy_(n_n)
            # the sLSTM step is its scan of length 1
            st = tuple(cache[k][g] for k in s_keys)
            h, new = self._s_block(sp, h, state=st)
            for old, nw in zip(st, new):
                old.copy_(nw)
        h = cm.rms_norm(h, params["final_norm"], c.norm_eps)
        logits = cm._mm(h, params["unembed"])[:, 0]
        cache["pos"] = cache["pos"] + 1
        return logits, cache

    # -------------------------------------------------------------- dry-run
    def input_specs(self, shape: ShapeConfig) -> Dict:
        return token_specs(shape)

    def input_axes(self, shape: ShapeConfig) -> Dict:
        return token_axes(shape, self.input_specs(shape))
