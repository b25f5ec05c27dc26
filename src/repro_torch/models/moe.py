"""Mixture-of-Experts LM (qwen3-moe 128e/top-8, grok-1 8e/top-2).

Dispatch is the reference's loop over expert chunks with
capacity-bounded gather: per expert, the top-C tokens of each sequence
by gate weight, the expert FFN on the (C, d) slab, a scatter-add back.
Compute = Σ_e C·3·d·f = tokens·k·ffn_flops, the active FLOPs of the
config. Plain PyTorch: the reference has no Pallas kernel here.

Top-k order: XLA's `top_k` puts the lower index first among equal
values, and in the capacity step every token an expert was not routed
to scores -1.0, so ties are the rule there. `torch.topk` promises no
order among ties; `xla_top_k` takes a stable descending sort, so the
selected indices (masked or not, they reach the scatter) are the
reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard
from repro_torch.models import common as cm
from repro_torch.models.transformer import DenseLM


def xla_top_k(x: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, in
    descending order, the lower index first among equal values (XLA's
    `top_k`)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Tokens an expert takes from each sequence (the reference's
    truncation, clamped to [1, S])."""
    return min(S, max(1, int(S * top_k / n_experts * capacity_factor)))


def expert_chunk(n_experts: int) -> int:
    """Experts run together in one step of the dispatch loop."""
    for cand in (16, 8, 4, 2, 1):
        if n_experts % cand == 0:
            return cand
    return 1


def route(x, w_router, k: int):
    """The fp32 router: (B,S,Ex) gate weights, each token's top-k
    probabilities renormalised to sum to one, zero elsewhere."""
    logits = cm._f32(x) @ cm._f32(w_router)
    probs = torch.softmax(logits, dim=-1)
    top_v, top_i = xla_top_k(probs, k)                        # (B,S,k)
    top_v = top_v / torch.clamp(top_v.sum(-1, keepdim=True), min=1e-9)
    return torch.zeros_like(probs).scatter_add(-1, top_i, top_v)


def capacity_select(gate, C: int):
    """gate (EC,B,S) → (cap_v, cap_i) (EC,B,C): each expert's top-C
    tokens of each sequence; tokens not routed to it score -1.0."""
    score = torch.where(gate > 0, gate, torch.full_like(gate, -1.0))
    return xla_top_k(score, C)


def moe_ffn(x, w_router, w_gate, w_up, w_down, top_k: int,
            capacity_factor: float):
    """x (B,S,E) → (B,S,E). Expert weights stacked on axis 0 (Ex, ...).

    Group-local capacity (group = sequence): each expert takes its top-C
    tokens per sequence, so select, gather and scatter act along S."""
    B, S, E = x.shape
    Ex, _, Fd = w_gate.shape
    gate = route(x, w_router, top_k)
    C = capacity(S, top_k, Ex, capacity_factor)
    EC = expert_chunk(Ex)
    NC = Ex // EC
    rows = torch.arange(B, device=x.device)[None, :, None].expand(EC, B, C)
    gate_c = gate.movedim(-1, 0).reshape(NC, EC, B, S)
    acc = torch.zeros((B, S, E), dtype=x.dtype, device=x.device)
    for g, wg, wu, wd in zip(gate_c.unbind(0),
                             w_gate.reshape(NC, EC, E, Fd).unbind(0),
                             w_up.reshape(NC, EC, E, Fd).unbind(0),
                             w_down.reshape(NC, EC, Fd, E).unbind(0)):
        cap_v, cap_i = capacity_select(g, C)                    # (EC,B,C)
        keep = (cap_v > 0).to(torch.float32)
        xe = x[rows, cap_i].reshape(EC, B * C, E)
        h = cm._mm(xe, wg)
        u = cm._mm(xe, wu)
        h = F.silu(cm._f32(h)).to(xe.dtype) * u
        y = cm._mm(h, wd).reshape(EC, B, C, E)
        y = y * (cap_v * keep)[..., None].to(y.dtype)
        acc = acc.index_put((rows, cap_i), y, accumulate=True)
    return acc


class MoELM(DenseLM):
    def param_defs(self) -> cm.ParamDefs:
        c = self.cfg
        defs = super().param_defs()
        L, E, F_, Ex = c.n_layers, c.d_model, c.d_ff, c.n_experts
        for n in ("w_gate", "w_up", "w_down"):
            defs.pop(f"layers/{n}")
        defs["layers/router"] = ((L, E, Ex), ("layers", "embed", None))
        defs["layers/moe_gate"] = ((L, Ex, E, F_),
                                   ("layers", "experts", "embed", "ffn"))
        defs["layers/moe_up"] = ((L, Ex, E, F_),
                                 ("layers", "experts", "embed", "ffn"))
        defs["layers/moe_down"] = ((L, Ex, F_, E),
                                   ("layers", "experts", "ffn", "embed"))
        return defs

    def _mlp(self, lp, h):
        y = moe_ffn(h, lp["router"], lp["moe_gate"], lp["moe_up"],
                    lp["moe_down"], self.cfg.top_k, self.cfg.capacity_factor)
        return shard(y, ("batch", "seq", "embed_act"))

    def active_params_per_token(self) -> int:
        """N_active for MODEL_FLOPS = 6·N_active·D (roofline)."""
        c = self.cfg
        attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        moe = c.top_k * 3 * c.d_model * c.d_ff + c.d_model * c.n_experts
        embed = 2 * c.d_model * c.vocab
        return c.n_layers * (attn + moe) + embed
