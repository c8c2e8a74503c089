"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437): the
reference's ``repro.models.mla`` in PyTorch.

Training and prefill up-project the latent K/V and attend as usual, the
q·k head dim ``qk_nope_head_dim + qk_rope_head_dim`` (192 at deepseek's
widths) and the v head dim ``v_head_dim`` (128).  The cache holds the
*compressed* latent (``kv_lora_rank``) and the one shared rope key
(``qk_rope_head_dim``) a token: (B, C, r + d_rope) a layer.  The decode
step **absorbs** the up-projections into the query and the output (in
float32), so that it reads the latent and never rebuilds K and V.

Weights are (in, out) matrices for one model or (C, in, out) for C
stacked cohorts, with x (B, S, d) or (C, B, S, d) (``common.linear``).
``q_norm`` and ``kv_norm`` are float32 rmsnorm scales (``1 + scale``).
Under tensor parallelism the full-sequence form runs on the rank's heads
(:func:`mla_attention`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common

#: the leaves the reference keeps in float32 whatever the model's dtype
FLOAT32 = ("q_norm", "kv_norm")


def mla_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": (d, m.q_lora_rank),
        "q_norm": (m.q_lora_rank,),
        "w_uq": (m.q_lora_rank, H * dq),
        "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_norm": (m.kv_lora_rank,),
        "w_uk": (m.kv_lora_rank, H * m.qk_nope_head_dim),
        "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
        "wo": (H * m.v_head_dim, d),
    }


def init_mla_params(gen: torch.Generator, cfg: ModelConfig, *,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """N(0, 1/fan_in) for every matrix in ``dtype``; the norms' scales
    float32 zeros."""
    p = {}
    for name, shape in mla_param_shapes(cfg).items():
        if name in FLOAT32:
            p[name] = torch.zeros(shape, device=gen.device)
        else:
            p[name] = common.dense_init(gen, shape, dtype=dtype)
    return p


def latent_width(cfg: ModelConfig) -> int:
    """A cache entry's width: the latent and the shared rope key."""
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


def _queries(params, x, positions, cfg: ModelConfig, tp=None):
    """x (..., S, d) -> q_nope (..., S, H, nope), q_rope (..., S, H, rope);
    where w_uq holds one model rank's heads, the rank's, f on the normed
    query latent (:func:`mla_attention`)."""
    m = cfg.mla
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    ql = common.rmsnorm(common.linear(x, params["w_dq"]), params["q_norm"])
    if tp is not None and params["w_uq"].shape[-1] < cfg.n_heads * dq:
        q = common.column_linear(common.column_input(ql, tp), params["w_uq"])
    else:
        q = common.linear(ql, params["w_uq"])
    q = q.reshape(*x.shape[:-1], -1, dq)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = common.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                               cfg.rope_theta)
    return q_nope, q_rope


def _latent(params, x, positions, cfg: ModelConfig):
    """The compressed kv: latent (..., S, r), k_rope (..., S, 1, d_rope)."""
    r = cfg.mla.kv_lora_rank
    dkv = common.linear(x, params["w_dkv"])
    latent = common.rmsnorm(dkv[..., :r], params["kv_norm"])
    k_rope = common.apply_rope(dkv[..., r:][..., None, :], positions,
                               cfg.rope_theta)         # one shared head
    return latent, k_rope


def mla_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  positions: torch.Tensor, cfg: ModelConfig, *,
                  window: int = 0, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence MLA (train / prefill): x (B, S, d), or (C, B, S, d)
    with stacked weights; positions (B, S).  Returns (out, the cache's
    entries (..., S, r + d_rope): the latent and the rope'd shared key).

    Where w_uq holds one model rank's heads (tensor parallelism over
    ``tp``; w_uk and w_uv then too), the rank attends with its heads: the
    replicated low-rank path (w_dq, w_dkv and the two norms) runs whole,
    f where it ends (on the normed query latent, the normed kv latent and
    the rope'd shared key, so that its gradient sums every rank's heads),
    and wo is row-parallel (``common.row_linear``).  Where the heads do not
    divide the model axis the rules replicate MLA, and it runs whole."""
    m = cfg.mla
    lead, H = x.shape[:-1], cfg.n_heads
    q_nope, q_rope = _queries(params, x, positions, cfg, tp)
    latent, k_rope = _latent(params, x, positions, cfg)
    Hl = q_nope.shape[-2]
    if Hl < H:
        lat32 = common.column_input(latent, tp)
        k_nope = common.column_linear(lat32, params["w_uk"])
        v = common.column_linear(lat32, params["w_uv"])
        # the shared key's gradient summed over the heads in float32
        k_shared = common.column_input(k_rope, tp).expand(
            *lead, Hl, m.qk_rope_head_dim).to(k_nope.dtype)
    else:
        k_nope = common.linear(latent, params["w_uk"])
        v = common.linear(latent, params["w_uv"])
        k_shared = k_rope.expand(*lead, H, m.qk_rope_head_dim)
    k = torch.cat([k_nope.reshape(*lead, Hl, m.qk_nope_head_dim), k_shared],
                  -1)
    v = v.reshape(*lead, Hl, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    o = attn.attend(q, k, v, positions, positions, causal=True, window=window)
    o = o.reshape(*lead, -1)
    out = (common.row_linear(o, params["wo"], tp) if Hl < H
           else common.linear(o, params["wo"]))
    return out, torch.cat([latent, k_rope[..., 0, :]], -1)


def mla_decode(params: Dict[str, torch.Tensor], x: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig, *,
               cache: torch.Tensor, kv_pos: torch.Tensor,
               write_slot: torch.Tensor, window: int = 0) -> torch.Tensor:
    """Absorbed one-token decode.  x (B, 1, d); positions (B, 1); cache
    (B, C, r + d_rope); kv_pos (B, C) before the write; write_slot a (1,)
    int64 tensor, every row's slot.  Writes the token's entry into the
    cache **in place** (the reference returns the written cache) and
    returns the output (B, 1, d); the model updates kv_pos."""
    m = cfg.mla
    B, H, r = x.shape[0], cfg.n_heads, m.kv_lora_rank
    q_nope, q_rope = _queries(params, x, positions, cfg)          # (B,1,H,·)
    latent_new, k_rope_new = _latent(params, x, positions, cfg)
    entry = torch.cat([latent_new, k_rope_new[:, :, 0, :]], -1)
    cache.index_copy_(1, write_slot, entry.to(cache.dtype))
    new_kv_pos = kv_pos.index_copy(1, write_slot, positions.to(kv_pos.dtype))

    lat = cache[..., :r].float()                                   # (B,C,r)
    kr = cache[..., r:].float()                                    # (B,C,dr)
    # W_uk absorbed into q: scores_nope[h, s] = (q_nope[h] W_uk[h]^T) · lat[s]
    w_uk = params["w_uk"].reshape(r, H, m.qk_nope_head_dim).float()
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), w_uk)
    scores = torch.einsum("bqhr,bsr->bhqs", q_lat, lat)
    scores = scores + torch.einsum("bqhd,bsd->bhqs", q_rope.float(), kr)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    bias = common._mask_bias(positions, new_kv_pos, causal=True,
                             window=window)
    p = torch.softmax(scores * scale + bias[:, None], dim=-1)     # (B,H,1,C)
    # the output absorbed: (p @ latent) @ W_uv, then wo
    o_lat = torch.einsum("bhqs,bsr->bqhr", p, lat)
    w_uv = params["w_uv"].reshape(r, H, m.v_head_dim).float()
    o = torch.einsum("bqhr,rhd->bqhd", o_lat, w_uv)
    return common.linear(o.reshape(B, 1, -1).to(x.dtype), params["wo"])
