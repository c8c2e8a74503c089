"""GQA self-attention layer: projections, rope, the full-sequence
attention of training and prefill, and one-token decode against a cache;
and whisper's cross-attention (the decoder's queries against the
encoder's k and v, projected once: ``project_cross_kv``).

Weights are (d, H·hd) matrices for one model or (C, d, H·hd) for C stacked
cohorts, with x (B, S, d) or (C, B, S, d) (``common.linear``).

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
                 cfg: ModelConfig):
    """x (..., S, d) -> q (..., S, H, hd), k and v (..., S, KV, hd)."""
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    q = common.linear(x, params["wq"])
    k = common.linear(x, params["wk"])
    v = common.linear(x, params["wv"])
    if cfg.qkv_bias:
        q = common.add_bias(q, params["bq"])
        k = common.add_bias(k, params["bk"])
        v = common.add_bias(v, params["bv"])
    lead = x.shape[:-1]
    return (q.reshape(*lead, H, hd), k.reshape(*lead, KV, hd),
            v.reshape(*lead, KV, hd))


def self_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig, *,
                   window: int = 0, rope: bool = True
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence causal self-attention (train / prefill).

    x (B, S, d), or (C, B, S, d) with stacked weights; positions (B, S).
    Returns (out, (k, v)), k and v already rope'd (the cache's entries).
    """
    q, k, v = _project_qkv(params, x, cfg)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    o = attend(q, k, v, positions, positions, causal=True, window=window)
    out = common.linear(o.reshape(*x.shape[:-1], -1), params["wo"])
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
                    cfg: ModelConfig) -> torch.Tensor:
    """Decoder-to-encoder attention (whisper): x (..., S, d) attends to
    enc_k and enc_v (..., Se, KV, hd) with every position 0, no mask and
    no rope.  Returns (..., S, d)."""
    hd = cfg.resolved_head_dim
    q = common.linear(x, params["wq"])
    if cfg.qkv_bias:
        q = common.add_bias(q, params["bq"])
    q = q.reshape(*x.shape[:-1], cfg.n_heads, hd)
    zero = torch.zeros((1,), dtype=torch.int32, device=x.device)
    o = attend(q, enc_k, enc_v, zero, zero, causal=False)
    return common.linear(o.reshape(*x.shape[:-1], -1), params["wo"])


def project_cross_kv(params: Dict[str, torch.Tensor], enc_out: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's k and v (..., Se, KV, hd), once for every decode
    step."""
    hd, KV = cfg.resolved_head_dim, cfg.n_kv_heads
    k = common.linear(enc_out, params["wk"])
    v = common.linear(enc_out, params["wv"])
    if cfg.qkv_bias:
        k = common.add_bias(k, params["bk"])
        v = common.add_bias(v, params["bv"])
    lead = enc_out.shape[:-1]
    return k.reshape(*lead, KV, hd), v.reshape(*lead, KV, hd)
