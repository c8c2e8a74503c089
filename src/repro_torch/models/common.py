"""Shared model building blocks: inits, norms, activations, rotary, attention.

The reference's functions over explicit parameter dicts, in PyTorch.  Every
weight may carry a leading **cohort** dimension: a matrix is (in, out) for
one model or (C, in, out) for C models stacked, and then the activations
lead with the same C (``linear``).  The cohort round trains its C cohorts
so, one stacked forward and one backward for all of them.

``attention`` is the reference's chunked online softmax written in plain
tensor ops (the reference's is plain ``jnp`` too, not a Pallas kernel):
the small one-einsum path, and the chunked path that never holds the full
(Sq, Skv) score matrix, its scan over key chunks a Python loop here.

Under tensor parallelism (``sharding.placement``) a weight may be one
model rank's block: the forwards read that from its shape and
``tp.model_index`` (``tp`` a ``core.comm.Comm``), put f
(``comm.copy_to_model``) at a column-parallel product's input and take a
row-parallel product through :func:`row_linear` (g).  With ``tp=None``
every block is the whole leaf and nothing changes.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30
#: elements above which ``dense_init`` draws a leaf a slice at a time
SLICED_INIT = 1 << 30

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], in_axis: int = -2,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in), fan_in = ``shape[in_axis]`` (``shape[0]`` for a
    vector); drawn in float32 and cast once (a slice along axis 0 at a
    time above SLICED_INIT elements)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    if math.prod(shape) <= SLICED_INIT:
        w = torch.randn(shape, generator=gen, device=gen.device)
        return (w * fan_in ** -0.5).to(dtype)
    # a leaf past SLICED_INIT (deepseek-v3's (256, 7168, 2048) experts):
    # one slice along axis 0 at a time, never the whole leaf in float32
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    for row in w:
        row.copy_(torch.randn(shape[1:], generator=gen, device=gen.device)
                  * fan_in ** -0.5)
    return w


def embed_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return w.to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for one model, w (in, out) and x (..., in); or per cohort,
    w (C, in, out) and x (C, ..., in), one batched product."""
    if w.dim() == 2:
        return x @ w
    C = w.shape[0]
    out = torch.bmm(x.reshape(C, -1, x.shape[-1]), w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def column_input(x: torch.Tensor, tp) -> torch.Tensor:
    """f on x in float32 (cast exactly): the input of column-parallel
    products (:func:`column_linear`), whose gradient then sums every
    model rank's float32 partial before it is rounded once to x's
    dtype, as the whole product's gradient rounds its float32 sum once."""
    return comm_mod.copy_to_model(x.float(), tp)


def column_linear(x32: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`linear` of a :func:`column_input` and w's block of output
    columns: the product in float32, rounded once to w's dtype."""
    return linear(x32, w.float()).to(w.dtype)


def row_linear(x: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """:func:`linear` where ``w`` holds one model rank's block of its input
    rows and ``x`` the matching block of features: the partial product in
    float32 (a bfloat16 operand cast exactly), summed over the model group
    (``comm.reduce_from_model``) and rounded once to x's dtype, as the
    whole product rounds its float32 sum once."""
    out = linear(x.float(), w.float())
    return comm_mod.reduce_from_model(out, tp).to(x.dtype)


def own_block(t: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """The model rank's block of ``t`` along ``dim`` (the
    ``tp.model_index``-th of ``tp.model_size`` equal contiguous blocks),
    taken through f: ``t`` is whole and the same on every rank, and each
    rank uses a different part of it, so its gradient sums over the model
    group."""
    n = t.shape[dim] // tp.model_size
    return comm_mod.copy_to_model(t, tp).narrow(dim, tp.model_index * n, n)


def promoted_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`linear` at x's dtype, the weight cast to it (exactly, from
    bfloat16 to float32): JAX promotes a product of float32 activations
    and a bfloat16 weight so, where torch refuses mixed dtypes."""
    return linear(x, w.to(x.dtype))


def add_bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x + b with b (out,), or (C, out) against x (C, ..., out)."""
    if b.dim() == 1:
        return x + b
    return x + b.reshape(b.shape[0], *([1] * (x.dim() - 2)), b.shape[-1])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def per_cohort(p: torch.Tensor, x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """A parameter whose last ``k`` axes align with x's last ``k`` (a (d,)
    norm scale: k = 1): as is for one model, a stacked (C, ...) one shaped
    (C, 1, ..., 1, ...) to broadcast against x (C, ...)."""
    if p.dim() == k:
        return p
    return p.reshape(p.shape[0], *([1] * (x.dim() - 1 - k)), *p.shape[1:])


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * (1.0 + per_cohort(scale, x).float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        out = out * per_cohort(scale, x).float()
    if bias is not None:
        out = out + per_cohort(bias, x).float()
    return out.to(x.dtype)


def norm_param_shapes(cfg: ModelConfig, d: int) -> Dict[str, Tuple[int, ...]]:
    """The leaves of one norm's parameters, by name: none for
    ``nonparametric_ln``."""
    if cfg.norm_type == "rmsnorm":
        return {"scale": (d,)}
    if cfg.norm_type == "layernorm":
        return {"bias": (d,), "scale": (d,)}
    if cfg.norm_type == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm_type)


def make_norm_params(cfg: ModelConfig, d: int, *, device: DeviceLike = None
                     ) -> Dict[str, torch.Tensor]:
    """rmsnorm's scale starts at 0 (it multiplies by 1 + scale), layernorm's
    at 1 with a zero bias; float32, as the reference keeps them."""
    device = resolve_device(device)
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.zeros((d,), device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    if cfg.norm_type == "nonparametric_ln":
        return {}
    raise ValueError(cfg.norm_type)


def apply_norm(x: torch.Tensor, params: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if cfg.norm_type == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if cfg.norm_type == "nonparametric_ln":
        return layernorm(x, None, None)
    raise ValueError(cfg.norm_type)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "relu2":  # squared ReLU (Nemotron-4)
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: DeviceLike = None) -> torch.Tensor:
    device = resolve_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to x's (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs      # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (chunked online softmax, plain tensor ops)
# ---------------------------------------------------------------------------


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window: int) -> torch.Tensor:
    """(…, Sq, Skv) additive bias. kv_pos < 0 marks invalid cache slots."""
    kv = kv_pos[..., None, :]
    q = q_pos[..., :, None]
    valid = kv >= 0
    if causal:
        valid = valid & (kv <= q)
    if window > 0:
        valid = valid & (kv > q - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool = True,
              window: int = 0, q_chunk: int = 512,
              kv_chunk: int = 1024) -> torch.Tensor:
    """GQA attention with chunked online softmax.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); H % KV == 0.
    q_pos: (B, Sq) int; kv_pos: (B, Skv) int (−1 ⇒ invalid slot).
    Returns (B, Sq, H, hd).  Scores and the softmax run in float32; the
    chunked path (Sq·Skv above 4·q_chunk·kv_chunk and Sq at least q_chunk)
    keeps O(q_chunk·kv_chunk) scores a head alive.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    hd_v = v.shape[-1]
    scale = hd ** -0.5
    in_dtype = q.dtype
    qg = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    k32, v32 = k.float(), v.float()

    if Sq * Skv <= q_chunk * kv_chunk * 4 or Sq < q_chunk:
        # small / decode path: one einsum, full bias
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k32)
        s = s + _mask_bias(q_pos, kv_pos, causal=causal,
                           window=window)[:, None, None]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v32)
        return o.reshape(B, Sq, H, hd_v).to(in_dtype)

    # ---- chunked path -----------------------------------------------------
    pad_q = (q_chunk - Sq % q_chunk) % q_chunk
    pad_k = (kv_chunk - Skv % kv_chunk) % kv_chunk
    if pad_q:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-2)
    if pad_k:
        k32 = F.pad(k32, (0, 0, 0, 0, 0, pad_k))
        v32 = F.pad(v32, (0, 0, 0, 0, 0, pad_k))
        kv_pos = F.pad(kv_pos, (0, pad_k), value=-1)
    nq, nk = (Sq + pad_q) // q_chunk, (Skv + pad_k) // kv_chunk

    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qb, qpb = qg[:, qs], q_pos[:, qs]           # (B,qc,KV,G,hd), (B,qc)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, q_chunk), device=q.device)
        acc = torch.zeros((B, KV, G, q_chunk, hd_v), device=q.device)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, k32[:, ks])
            s = s + _mask_bias(qpb, kv_pos[:, ks], causal=causal,
                               window=window)[:, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskh->bkgqh", p, v32[:, ks])
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,KV,G,qc,hd)
        outs.append(out.permute(0, 3, 1, 2, 4))             # (B,qc,KV,G,hd)
    out = torch.cat(outs, dim=1)[:, :Sq]
    return out.reshape(B, Sq, H, hd_v).to(in_dtype)
