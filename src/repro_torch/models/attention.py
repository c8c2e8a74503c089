"""GQA self-attention layer: projections, rope, the full-sequence
attention of training and prefill, and one-token decode against a cache;
and whisper's cross-attention (the decoder's queries against the
encoder's k and v, projected once: ``project_cross_kv``).

Weights are (d, H·hd) matrices for one model or (C, d, H·hd) for C stacked
cohorts, with x (B, S, d) or (C, B, S, d) (``common.linear``).

Under tensor parallelism (``sharding.placement``) a rank whose wq holds a
block of the heads runs its query heads and the kv heads they read
(``_local_q``, ``_local_kv``), and wo row-parallel; so does the
cross-attention, its k and v projected from the encoder's states that the
caller passed through f once for every layer (``project_cross_kv``).

Cache convention (per layer), as the reference's: k and v (B, C, KV, hd)
in the model's dtype, C the capacity (the context, or the window of a
sliding-window cache); ``kv_pos`` (B, C) int32 the absolute position each
slot holds, −1 where it holds none, shared by every layer and kept by the
model.  Decode writes the token's k and v at the slot ``length % C`` and
attends over the cache with the token in it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.models import common


def attention_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
              "wo": (H * hd, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(H * hd,), bk=(KV * hd,), bv=(KV * hd,))
    return shapes


def init_attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    p = {}
    for name, shape in attention_param_shapes(cfg).items():
        if name.startswith("b"):
            p[name] = torch.zeros(shape, dtype=dtype, device=gen.device)
        else:
            p[name] = common.dense_init(gen, shape, dtype=dtype)
    return p


def _project_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, tp=None):
    """x (..., S, d) -> q (..., S, H, hd), k and v (..., S, KV, hd); under
    tensor parallelism the rank's heads (:func:`_local_qkv`)."""
    hd = cfg.resolved_head_dim
    lead = x.shape[:-1]
    if _tp_heads(params, cfg, tp):
        q, k, v = _local_qkv(params, x, cfg, tp)
    else:
        q = common.linear(x, params["wq"])
        k = common.linear(x, params["wk"])
        v = common.linear(x, params["wv"])
        if cfg.qkv_bias:
            q = common.add_bias(q, params["bq"])
            k = common.add_bias(k, params["bk"])
            v = common.add_bias(v, params["bv"])
    return (q.reshape(*lead, -1, hd), k.reshape(*lead, -1, hd),
            v.reshape(*lead, -1, hd))


def _local_qkv(params: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, tp):
    """Rank m's query heads and the kv heads they read
    (:func:`_local_q`, :func:`_local_kv`), x through f once."""
    xin = common.column_input(x, tp)
    return (_local_q(params, xin, cfg, tp), *_local_kv(params, xin, cfg, tp))


def _pick(t: torch.Tensor, cols, tp) -> torch.Tensor:
    """Columns ``cols`` (a slice or an index tensor) of a replicated leaf
    through f: each rank uses a part of it, so its gradient sums over the
    model group."""
    t = comm_mod.copy_to_model(t, tp)
    return t[..., cols] if isinstance(cols, slice) else \
        t.index_select(-1, cols)


def _local_q(params: Dict[str, torch.Tensor], xin: torch.Tensor,
             cfg: ModelConfig, tp) -> torch.Tensor:
    """Rank m's query heads [m·Hl, (m+1)·Hl) (wq holds their columns) from
    ``xin`` (``common.column_input``), with their block of the replicated
    bias."""
    hd = cfg.resolved_head_dim
    Hl = params["wq"].shape[-1] // hd
    first = tp.model_index * Hl
    q = common.column_linear(xin, params["wq"])
    if cfg.qkv_bias:
        q = common.add_bias(q, _pick(params["bq"],
                                     slice(first * hd, (first + Hl) * hd), tp))
    return q


def _local_kv(params: Dict[str, torch.Tensor], xin: torch.Tensor,
              cfg: ModelConfig, tp):
    """The kv heads rank m's query heads read, head h reading kv head
    h // (H / KV): wk and wv's own columns where they shard too, else the
    columns of those kv heads taken from the replicated wk and wv (a
    contiguous run where the heads group evenly, one kv head a query head
    otherwise).  The biases replicate, and each rank takes its heads'
    block of them."""
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    Hl = params["wq"].shape[-1] // hd
    first = tp.model_index * Hl
    KVl = params["wk"].shape[-1] // hd
    if KVl < KV:                    # kv heads shard too
        wcols, bcols = None, slice(tp.model_index * KVl * hd,
                                   (tp.model_index + 1) * KVl * hd)
    else:
        heads = [(first + j) // (H // KV) for j in range(Hl)]
        lo, n = heads[0], heads[-1] - heads[0] + 1
        if heads == [lo + j * n // Hl for j in range(Hl)]:
            wcols = slice(lo * hd, (lo + n) * hd)
        else:
            wcols = torch.tensor([h * hd + i for h in heads
                                  for i in range(hd)], device=xin.device)
        bcols = wcols
    out = []
    for w, b in (("wk", "bk"), ("wv", "bv")):
        wt = params[w] if wcols is None else _pick(params[w], wcols, tp)
        y = common.column_linear(xin, wt)
        out.append(common.add_bias(y, _pick(params[b], bcols, tp))
                   if cfg.qkv_bias else y)
    return out[0], out[1]


def self_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig, *,
                   window: int = 0, rope: bool = True, tp=None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (train / prefill).

    x (B, S, d), or (C, B, S, d) with stacked weights; positions (B, S).
    Returns (out, (k, v)), k and v already rope'd (the cache's entries).
    Where wq holds one model rank's heads (tensor parallelism over ``tp``),
    the rank attends with its heads and wo, row-parallel, sums the output
    over the model group.
    """
    q, k, v = _project_qkv(params, x, cfg, tp)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, positions, positions, causal=True, window=window)
    o = o.reshape(*x.shape[:-1], -1)
    if _tp_heads(params, cfg, tp):
        out = common.row_linear(o, params["wo"], tp)
    else:
        out = common.linear(o, params["wo"])
    return out, (k, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
           window: int = 0) -> torch.Tensor:
    """``common.attention`` over q (..., Sq, H, hd), k and v (..., Skv, KV,
    ·), the leading dims (the C cohorts of a stacked call, the batch)
    folded into the attention's batch; q_pos and kv_pos broadcast to
    (..., Sq) and (..., Skv).  Returns (..., Sq, H, hd_v)."""
    lead, Sq, Skv = q.shape[:-3], q.shape[-3], k.shape[-3]
    rows = lead.numel()
    o = common.attention(
        q.reshape(rows, Sq, *q.shape[-2:]), k.reshape(rows, Skv, *k.shape[-2:]),
        v.reshape(rows, Skv, *v.shape[-2:]),
        q_pos.expand(*lead, Sq).reshape(rows, Sq),
        kv_pos.expand(*lead, Skv).reshape(rows, Skv),
        causal=causal, window=window)
    return o.reshape(*lead, Sq, *o.shape[-2:])


def decode_self_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                          positions: torch.Tensor, cfg: ModelConfig, *,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          kv_pos: torch.Tensor, write_slot: torch.Tensor,
                          window: int = 0, rope: bool = True) -> torch.Tensor:
    """One-token decode. x (B, 1, d); positions (B, 1), the token's absolute
    position; cache_k and cache_v (B, C, KV, hd); kv_pos (B, C) before the
    write; write_slot a (1,) int64 tensor, the slot of every row (the
    reference takes one a row: all rows share ``length % C``).

    Writes k and v into the cache **in place**, where the reference returns
    the written cache (its jitted step is donated the cache), and returns
    the attention's output (B, 1, d); the model updates kv_pos once for
    all layers."""
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    cache_k.index_copy_(1, write_slot, k.to(cache_k.dtype))
    cache_v.index_copy_(1, write_slot, v.to(cache_v.dtype))
    new_kv_pos = kv_pos.index_copy(1, write_slot, positions.to(kv_pos.dtype))
    o = common.attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                         positions, new_kv_pos, causal=True, window=window)
    return common.linear(o.reshape(B, 1, -1), params["wo"])


def init_cross_attention_params(gen: torch.Generator, cfg: ModelConfig, *,
                                dtype: torch.dtype = torch.float32
                                ) -> Dict[str, torch.Tensor]:
    return init_attention_params(gen, cfg, dtype=dtype)


def cross_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Decoder-to-encoder attention (whisper): x (..., S, d) attends to
    enc_k and enc_v (..., Se, KV, hd) with every position 0, no mask and
    no rope.  Returns (..., S, d).  Where wq holds one model rank's heads
    (tensor parallelism over ``tp``), the rank's query heads attend to the
    kv heads :func:`project_cross_kv` gave it, and wo is row-parallel."""
    hd = cfg.resolved_head_dim
    local = _tp_heads(params, cfg, tp)
    if local:
        q = _local_q(params, common.column_input(x, tp), cfg, tp)
    else:
        q = common.linear(x, params["wq"])
        if cfg.qkv_bias:
            q = common.add_bias(q, params["bq"])
    q = q.reshape(*x.shape[:-1], -1, hd)
    zero = torch.zeros((1,), dtype=torch.int32, device=x.device)
    o = attend(q, enc_k, enc_v, zero, zero, causal=False)
    o = o.reshape(*x.shape[:-1], -1)
    return (common.row_linear(o, params["wo"], tp) if local
            else common.linear(o, params["wo"]))


def project_cross_kv(params: Dict[str, torch.Tensor], enc_out: torch.Tensor,
                     cfg: ModelConfig, tp=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's k and v (..., Se, KV, hd), once for every decode
    step; under tensor parallelism the kv heads the rank's query heads
    read (:func:`_local_kv`), from ``enc_out`` through f
    (``common.column_input``), which the caller takes once for all its
    layers, so that the encoder's gradient sums every rank's heads."""
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    lead = enc_out.shape[:-1]
    if _tp_heads(params, cfg, tp):
        k, v = _local_kv(params, enc_out, cfg, tp)
        return k.reshape(*lead, -1, hd), v.reshape(*lead, -1, hd)
    k = common.linear(enc_out, params["wk"])
    v = common.linear(enc_out, params["wv"])
    if cfg.qkv_bias:
        k = common.add_bias(k, params["bk"])
        v = common.add_bias(v, params["bv"])
    return k.reshape(*lead, KV, hd), v.reshape(*lead, KV, hd)


def _tp_heads(params: Dict[str, torch.Tensor], cfg: ModelConfig, tp) -> bool:
    """Whether wq holds one model rank's block of the heads."""
    return tp is not None and \
        params["wq"].shape[-1] < cfg.n_heads * cfg.resolved_head_dim
