"""Shared model substrate: params-as-flat-dict, norms, RoPE/M-RoPE, GQA
attention (causal / local / cross / decode-with-cache, full and
blockwise), MLPs, the loss and the KV cache, as the JAX package's
`models/common.py` has them (its `scan_layers` switch excepted: the port
walks layers in Python loops).

Parameters are a FLAT dict {path: tensor}; each model declares
`param_defs(cfg) -> {path: (shape, logical_axes)}`, the one source of
truth for init, for the checkpoint's tensor names, and for the dry-run's
meta tensors (`param_structs`) and specs (`param_specs`).

Dtype flow is the reference's: norms, RoPE and the softmax compute in
fp32 and return their input's dtype; the attention score and PV products
take fp32 operands and return fp32 (`preferred_element_type=float32` in
the reference); a product of mixed bf16/fp32 operands computes in the
promoted type (`_mm`), as JAX promotes. On the card the fp32 products
need `torch.backends.cuda.matmul.allow_tf32` left at its default False
to stay IEEE fp32.

Everything here is plain PyTorch: the reference computes these in plain
`jnp`, outside any Pallas kernel.
"""
from __future__ import annotations

import functools
import hashlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import spec_for

ParamDefs = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]


def meta(shape, dtype) -> torch.Tensor:
    """A shape and dtype with no storage: the counterpart of the
    reference's `jax.ShapeDtypeStruct` in `cache_specs`/`input_specs`."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def subtree(params: Dict, prefix: str) -> Dict:
    """The leaves under `prefix/`, keyed by the rest of their path."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def unstack(tree: Dict) -> List[Dict]:
    """A dict of stacked `(N, ...)` leaves → N dicts of `torch.unbind`
    views. Indexing `w[i]` instead would make each slice's backward
    allocate a zero tensor of the whole stack."""
    names = sorted(tree)
    stacks = [torch.unbind(tree[n], 0) for n in names]
    return [dict(zip(names, layer)) for layer in zip(*stacks)]


# ------------------------------------------------------------------- params
def path_seed(base_seed: int, path: str) -> int:
    """A stable 63-bit seed for parameter `path` under `base_seed` (the
    reference folds Python's per-process salted `hash(path)` into its
    key, so its init differs from process to process; this does not)."""
    d = hashlib.blake2b(f"{int(base_seed)}/{path}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(d, "little") & (2 ** 63 - 1)


def init_params(defs: ParamDefs, generator: torch.Generator,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device: one generator a path,
    seeded by `path_seed(generator.initial_seed(), path)`; the reference's
    distributions (norms ones, biases zeros, N(0, 0.02) embeddings,
    N(0, 1/fan_in) otherwise)."""
    dev = generator.device
    base = generator.initial_seed()
    out = {}
    for path, (shape, _axes) in defs.items():
        last = path.split("/")[-1]
        if path.endswith(("norm", "norm_b", "bias", "b")) or "norm" in last:
            fill = (torch.ones if path.endswith("norm")
                    or last.startswith("norm") else torch.zeros)
            val = fill(shape, dtype=dtype, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = 0.02 if "embed" in path else 1.0 / math.sqrt(max(fan_in, 1))
            g = torch.Generator(device=dev)
            g.manual_seed(path_seed(base, path))
            val = (torch.randn(shape, generator=g, dtype=torch.float32,
                               device=dev) * std).to(dtype)
        out[path] = val
    return out


def param_structs(defs: ParamDefs, dtype=torch.bfloat16) -> Dict:
    """Meta tensors (no allocation) — the dry-run's params."""
    return {p: meta(s, dtype) for p, (s, _) in defs.items()}


def param_specs(defs: ParamDefs, rules=None) -> Dict:
    """{path: spec} from logical axes."""
    return {p: spec_for(a, rules) for p, (s, a) in defs.items()}


# ------------------------------------------------------------------ products
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in the promoted dtype of the two operands (JAX's einsum
    promotion: bf16 x fp32 computes and returns fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# -------------------------------------------------------------------- norms
def rms_norm(x, w, eps: float):
    h = _f32(x)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * _f32(w)).to(x.dtype)


def layer_norm(x, w, b, eps: float):
    h = _f32(x)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * _f32(w) + _f32(b)).to(x.dtype)


# --------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """`rope_freqs` on `device`, built once: a copy from pageable host
    memory waits for the device, which a decode step would otherwise do
    twice a layer."""
    return torch.from_numpy(np.asarray(rope_freqs(head_dim, theta),
                                       np.float32)).to(device)


def _rotate(x, ang):
    """Rotate the two halves of x's last axis by `ang` (..., S, D/2)."""
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(_f32(x), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x (..., S, H, D), positions (..., S) int32."""
    inv = _rope_table(x.shape[-1], theta, x.device)
    return _rotate(x, _f32(positions[..., None]) * inv)         # (..., S, D/2)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Qwen2-VL M-RoPE: positions3 (3, ..., S) t/h/w ids; `sections` gives
    how many rotary frequency pairs each coordinate owns (sums to D/2).
    Each section's angles are its coordinate times its slice of the
    frequencies, so t = h = w gives `apply_rope`'s angles bit for bit."""
    d = x.shape[-1]
    inv = _rope_table(d, theta, x.device)                        # (D/2,)
    sec = np.concatenate([[0], np.cumsum(sections)])
    assert sec[-1] == d // 2, "mrope sections must sum to head_dim/2"
    ang = torch.cat([_f32(positions3[i][..., None]) * inv[sec[i]:sec[i + 1]]
                     for i in range(3)], dim=-1)                # (..., S, D/2)
    return _rotate(x, ang)


# ---------------------------------------------------------------- attention
_NEG = torch.finfo(torch.float32).min


def _mask_bias(sq, sk, q_offset, causal: bool, window: int, device):
    qi = torch.arange(sq, dtype=torch.int32, device=device)[:, None] \
        + q_offset
    ki = torch.arange(sk, dtype=torch.int32, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window and window > 0:
        ok &= ki > qi - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG))


# global switch: "full" materializes (…,Sq,Sk) scores; "blockwise" runs the
# flash-attention recurrence over key chunks (online softmax). Train paths
# read this.
ATTN_IMPL = "full"
ATTN_KV_CHUNK = 1024


def set_attn_impl(impl: str, kv_chunk: int = 1024) -> None:
    global ATTN_IMPL, ATTN_KV_CHUNK
    ATTN_IMPL = impl
    ATTN_KV_CHUNK = kv_chunk


def gqa_attention(q, k, v, *, causal=True, window: int = 0, q_offset=0,
                  kv_len=None):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) → (B,Sq,H,D). fp32 softmax.

    q_offset shifts the query positions of the causal and window mask.
    kv_len: optional (B,) valid cache length (decode); positions ≥ kv_len
    are masked. Head grouping: H = KV · G.
    """
    if (ATTN_IMPL == "blockwise" and kv_len is None and q.shape[1] > 1
            and k.shape[1] % min(ATTN_KV_CHUNK, k.shape[1]) == 0):
        return gqa_attention_blockwise(q, k, v, causal=causal,
                                       window=window,
                                       kv_chunk=ATTN_KV_CHUNK)
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", _f32(qg), _f32(k)) * scale
    bias = _mask_bias(Sq, k.shape[1], q_offset, causal, window, q.device)
    scores = scores + bias[None, None, None]
    if kv_len is not None:
        ki = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
        live = ki[None] < kv_len[:, None]                       # (B, Sk)
        scores = scores.masked_fill(~live[:, None, None, None, :], _NEG)
    probs = torch.softmax(scores, dim=-1)                      # fp32
    out = torch.einsum("bkgqs,bskd->bqkgd", _f32(probs.to(q.dtype)), _f32(v))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def cross_attention(q, k, v):
    """Non-causal full cross attention (whisper decoder → encoder)."""
    return gqa_attention(q, k, v, causal=False, window=0)


def gqa_attention_blockwise(q, k, v, *, causal=True, window: int = 0,
                            kv_chunk: int = 1024):
    """Flash-style attention: a loop over key chunks with the
    online-softmax running (max, sum, acc) triple — the (Sq, Sk) score
    tensor never materializes beyond (Sq, kv_chunk). fp32 accumulators."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    C = min(kv_chunk, Sk)
    assert Sk % C == 0, "kv len must divide kv_chunk"
    NC = Sk // C
    qg = _f32(q.reshape(B, Sq, KV, G, D))
    scale = 1.0 / math.sqrt(D)
    qi = torch.arange(Sq, dtype=torch.int32, device=q.device)[:, None]
    m = torch.full((B, KV, G, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for j in range(NC):
        kj = _f32(k[:, j * C:(j + 1) * C])
        vj = v[:, j * C:(j + 1) * C]
        s = torch.einsum("bqkgd,bckd->bkgqc", qg, kj) * scale
        ki = j * C + torch.arange(C, dtype=torch.int32,
                                  device=q.device)[None, :]
        ok = torch.ones((Sq, C), dtype=torch.bool, device=q.device)
        if causal:
            ok &= ki <= qi
        if window and window > 0:
            ok &= ki > qi - window
        s = torch.where(ok[None, None, None], s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", _f32(p.to(q.dtype)), _f32(vj))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, Sq, H, D).to(q.dtype)


# --------------------------------------------------------------------- mlps
def swiglu(x, w_gate, w_up, w_down):
    g = _mm(x, w_gate)
    u = _mm(x, w_up)
    return _mm(F.silu(_f32(g)).to(x.dtype) * u, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = _mm(x, w_in) + b_in
    h = F.gelu(_f32(h), approximate="tanh").to(x.dtype)
    return _mm(h, w_out) + b_out


# -------------------------------------------------------------------- loss
def cross_entropy_loss(logits, labels, vocab: int):
    """logits (B,S,V) any dtype, labels (B,S) int → scalar mean nll,
    logsumexp in fp32."""
    lf = _f32(logits)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# -------------------------------------------------------------- kv caching
def kv_cache_specs(B: int, S: int, n_kv: int, head_dim: int, n_layers: int,
                   dtype=torch.bfloat16):
    """The cache's shapes and dtypes as meta tensors (no allocation)."""
    kv = (n_layers, B, S, n_kv, head_dim)
    return {"k": meta(kv, dtype), "v": meta(kv, dtype),
            "pos": meta((B,), torch.int32)}


def zeros_like_specs(specs: Dict, device) -> Dict:
    """A zero tensor on `device` for every meta tensor of `specs`."""
    return {k: torch.zeros(t.shape, dtype=t.dtype, device=device)
            for k, t in specs.items()}


def init_kv_cache(B: int, S: int, n_kv: int, head_dim: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda"):
    return zeros_like_specs(kv_cache_specs(B, S, n_kv, head_dim, n_layers,
                                           dtype), device)


# the reference's logical axes of the decode cache: the SEQUENCE axis
# shards over "model" (kv-head counts are too small and ragged to shard)
KV_CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", None, None),
    "v": ("layers", "batch", "kv_seq", None, None),
    "pos": ("batch",),
}
