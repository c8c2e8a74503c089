"""GQA self-attention layer: projections, rope and the full-sequence
attention of training and prefill.  One-token decode against a cache comes
with the serving slice (ROADMAP A13).

Weights are (d, H·hd) matrices for one model or (C, d, H·hd) for C stacked
cohorts, with x (B, S, d) or (C, B, S, d) (``common.linear``).
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
    S = x.shape[-2]
    q, k, v = _project_qkv(params, x, cfg)
    if rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    # the C cohorts of a stacked call fold into the attention's batch
    rows = x.shape[:-2].numel()
    pos = positions.expand(*x.shape[:-2], S).reshape(rows, S)
    o = common.attention(q.reshape(rows, S, *q.shape[-2:]),
                         k.reshape(rows, S, *k.shape[-2:]),
                         v.reshape(rows, S, *v.shape[-2:]), pos, pos,
                         causal=True, window=window)
    out = common.linear(o.reshape(*x.shape[:-1], -1), params["wo"])
    return out, (k, v)
