"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, matrix-valued
state with data-dependent decay; the reference's ``models/rwkv.py`` in
PyTorch.

Time-mix recurrence per head (k, v, r, w, u in R^hd, state S in R^{hd×hd}):
    S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + diag(u)·k_tᵀ v_t)
with data-dependent decay w_t = exp(−exp(w0 + lora_w(x̄_w))) and the five
ddlerp token-shift mixes (r, k, v, w, g) produced by a shared low-rank MLP.

The projections of the whole sequence run at once; the state update is a
Python loop over the tokens where the reference scans, one launch a token
(one decode step is one turn of it).  Every leaf may carry a leading cohort dimension C, the
activations then (C, B, S, d) (``common.linear``).

**Type promotion.**  The reference mixes its float32 leaves (``FLOAT32``)
into activations of the model's dtype, and JAX promotes: from the first
mix on, every product is ``float32 @ weight`` in float32 with the
(bfloat16) weight converted exactly.  PyTorch refuses a product of mixed
dtypes, so the port casts the weight up, never the activation down
(``common.promoted_linear``).  The time-mix returns float32, as the
reference's does, and the block rounds it into the residual stream.

Decode state per layer: {"S": (B, H, hd, hd) float32, "x_tm": (B, d),
"x_cm": (B, d)} in the model's dtype.

**Tensor parallelism** (``tp``, a ``core.comm.Comm``; the leaves one
model rank's blocks, ``sharding.placement``).  The rule: f
(``comm.copy_to_model``) goes where a tensor that is whole on every rank
meets a product or a narrowing that differs by rank, and g
(``comm.reduce_from_model``) after a partial sum; a gathered tensor
(``comm.gather_from_model``) is used whole by every rank, else f follows
it.  So: ``ddlerp_A``'s 5 × 32 columns split flat and ``ddlerp_B`` its
32 rows of every mix, which do not line up; f on the first mix, then
tanh's block gathered whole and ``ddlerp_B`` gathered whole (1.3 MB in
bfloat16 at rwkv6-7b's width, where summing the partial (B, S, 5, d)
mixes would move 20 bytes a channel a token), and every rank computes the
whole mixes.  f on the five mixes, then ``w_r``, ``w_k``, ``w_v`` and
``w_g`` column-parallel (the rank's channels); the decay's low rank
split on both sides alike, its partial sum summed by g, then narrowed to
the rank's channels through f, as are ``decay_base``, ``bonus_u`` and
``ln_x_scale``; the token loop and the per-head group norm on the rank's
heads, no collective; ``w_o`` row-parallel.  Where the model axis splits
a head (H not a multiple of it), r, k and v are gathered whole, every
rank runs every head, and y is narrowed through f to the rank's channels
for the gate and ``w_o``.  The channel mix: f on its key input,
``cm_wk`` column- and ``cm_wv`` row-parallel (g); ``cm_wr`` row-parallel
on the rank's channels of its input, taken through f, its sum (g) before
the sigmoid: both factors whole.  Each leaf whose placement does not
split is used whole, as with ``tp`` None.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.models import common

DDLERP_RANK = 32
DECAY_RANK = 64
MIXES = 5  # r, k, v, w, g

#: the leaves the reference's init keeps in float32 whatever the model's
#: dtype
FLOAT32 = frozenset({"mu_base", "decay_base", "bonus_u", "ln_x_scale",
                     "cm_mu_k", "cm_mu_r"})

Params = Dict[str, torch.Tensor]


def rwkv_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d, ff, H = cfg.d_model, cfg.d_ff, cfg.n_heads
    return {
        # time-mix
        "mu_base": (MIXES, d), "ddlerp_A": (d, MIXES * DDLERP_RANK),
        "ddlerp_B": (MIXES, DDLERP_RANK, d),
        "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
        "w_o": (d, d), "decay_base": (d,), "decay_A": (d, DECAY_RANK),
        "decay_B": (DECAY_RANK, d), "bonus_u": (H, d // H),
        "ln_x_scale": (d,),
        # channel-mix
        "cm_mu_k": (d,), "cm_mu_r": (d,), "cm_wk": (d, ff), "cm_wv": (ff, d),
        "cm_wr": (d, d),
    }


#: the float32 leaves' initial values (the reference's ``jnp.full``s)
_FILL = {"mu_base": 0.5, "decay_base": -4.0, "bonus_u": 0.0,
         "ln_x_scale": 1.0, "cm_mu_k": 0.5, "cm_mu_r": 0.5}


def init_rwkv_params(gen: torch.Generator, cfg: ModelConfig, *,
                     dtype: torch.dtype = torch.float32) -> Params:
    """The matrices N(0, 1/fan_in) in ``dtype`` (``ddlerp_B``'s fan-in its
    rank), the float32 leaves at the reference's constants; the draws are
    the port's own."""
    out = {}
    for name, shape in rwkv_param_shapes(cfg).items():
        if name in FLOAT32:
            out[name] = torch.full(shape, _FILL[name], device=gen.device)
        else:
            out[name] = common.dense_init(gen, shape, dtype=dtype)
    return out


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} along S; position 0 gets ``x_prev`` (..., B, d)."""
    return torch.cat([x_prev.to(x.dtype)[..., None, :], x[..., :-1, :]],
                     dim=-2)


def _ddlerp(params: Params, x: torch.Tensor, xs: torch.Tensor,
            tp=None) -> torch.Tensor:
    """Per-token mix coefficients -> the 5 mixed inputs (..., B, S, 5, d),
    float32 (``mu_base`` promotes), whole on every model rank of ``tp``."""
    delta = xs - x
    base_mix = params["mu_base"]                                # (.., 5, d)
    mixed0 = x + delta * common.per_cohort(base_mix[..., 0, :], x)
    A, B = params["ddlerp_A"], params["ddlerp_B"]
    if tp is not None and A.shape[-1] < MIXES * DDLERP_RANK:
        z = torch.tanh(common.promoted_linear(
            comm_mod.copy_to_model(mixed0, tp), A))
        z = comm_mod.gather_from_model(z, tp, -1)
        if B.shape[-2] < DDLERP_RANK:   # B splits only where A does
            B = comm_mod.gather_from_model(B, tp, -2)
    else:
        z = torch.tanh(common.promoted_linear(mixed0, A))
    z = z.reshape(*z.shape[:-1], MIXES, DDLERP_RANK)            # (.., B,S,5,R)
    dyn = torch.einsum("...bsmr,...mrd->...bsmd", z, B.to(z.dtype))
    mix = common.per_cohort(base_mix, dyn, 2) + dyn             # (.., B,S,5,d)
    return x[..., None, :] + delta[..., None, :] * mix


def time_mix(params: Params, x: torch.Tensor, state_S: torch.Tensor,
             x_prev: torch.Tensor, cfg: ModelConfig, tp=None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., B, S, d); state_S (..., B, H, hd, hd) float32; x_prev
    (..., B, d).  Returns (out (..., B, S, d) float32, new S, new x_prev).
    Under ``tp`` with ``w_r`` split over whole heads, the (whole) state
    is narrowed to the rank's heads, and the new S is theirs."""
    *lead, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    mm = common.promoted_linear
    mixed = _ddlerp(params, x, _shift(x, x_prev), tp)
    chan = tp is not None and params["w_r"].shape[-1] < d
    # the rules split decay_A's 64 columns wherever they split w_r's d on
    # the reference's meshes (model a power of two up to 16, d a multiple
    # of 64); another placement fails here rather than run untested
    assert tp is None or chan == (
        params["decay_A"].shape[-1] < DECAY_RANK), "decay_A, w_r split apart"
    own_heads = chan and H % tp.model_size == 0
    xr, xk, xv, xw, xg = (comm_mod.copy_to_model(mixed, tp) if chan
                          else mixed).unbind(-2)

    def heads(t):
        if chan and not own_heads:
            t = comm_mod.gather_from_model(t, tp, -1)
        return t.reshape(*lead, S, -1, hd).float()

    r = heads(mm(xr, params["w_r"]))
    k = heads(mm(xk, params["w_k"]))
    v = heads(mm(xv, params["w_v"]))
    g = F.silu(mm(xg, params["w_g"]))
    low = torch.tanh(mm(xw, params["decay_A"]))
    dsum = (common.row_linear(low, params["decay_B"], tp) if chan
            else mm(low, params["decay_B"]))
    base, u, scale = (params["decay_base"], params["bonus_u"],
                      params["ln_x_scale"])
    if own_heads:
        base, dsum, u, scale = (common.own_block(base, tp),
                                common.own_block(dsum, tp),
                                common.own_block(u, tp, -2),
                                common.own_block(scale, tp))
        Hl = u.shape[-2]
        state_S = state_S.narrow(-3, tp.model_index * Hl, Hl)
    decay = common.per_cohort(base, dsum) + dsum
    w = torch.exp(-torch.exp(decay.float())).reshape(*lead, S, -1, hd)
    u = common.per_cohort(u, state_S[..., 0], 2)                # (.., H, hd)

    # y_t = r_t·S_{t-1} + (r_t·(u ⊙ k_t)) v_t.  Only the state update
    # S_t = w_t ⊙ S_{t-1} + k_tᵀ v_t runs token by token, one launch a
    # token; the outer products, the bonus term and every r_t·S_{t-1} run
    # for all tokens at once (the states held: a (hd, hd) matrix a head a
    # token).  The tokens lead, so that each token's slice is contiguous,
    # and are unbound once: the backward stacks their gradients in one
    # write, where a select a token would zero-fill the whole tensor and
    # add into it once a token.
    bonus = (r * u[..., None, :, :] * k).sum(-1, keepdim=True) * v
    rs, ks, vs, ws = (a.movedim(-3, 0).contiguous() for a in (r, k, v, w))
    kv = (ks[..., :, None] * vs[..., None, :]).unbind(0)        # (.., hd, hd)
    ws = ws[..., :, None].unbind(0)                             # (.., hd, 1)
    states = [state_S]
    for t in range(S):
        states.append(torch.addcmul(kv[t], ws[t], states[-1]))
    prev = torch.stack(states[:-1])                             # S_{t-1}
    y = torch.matmul(rs[..., None, :], prev)[..., 0, :]         # (S, .., hd)
    y = y.movedim(0, -3) + bonus                                # (.., B,S,H,hd)
    S_prev = states[-1]

    # per-head groupnorm (population variance, eps 1e-5), then the gate
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(*lead, S, -1)
    y = y * common.per_cohort(scale, y)
    if chan and not own_heads:
        y = common.own_block(y, tp)
    gated = y.to(x.dtype) * g
    out = (common.row_linear(gated, params["w_o"], tp) if chan
           else mm(gated, params["w_o"]))
    return out, S_prev, x[..., -1, :]


def channel_mix(params: Params, x: torch.Tensor, x_prev: torch.Tensor,
                cfg: ModelConfig, tp=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (..., B, S, d) float32, new x_prev); under ``tp``
    (``cfg.d_ff`` tells whether ``cm_wk`` is a block) both factors of the
    output are whole on every model rank."""
    mm = common.promoted_linear
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * common.per_cohort(params["cm_mu_k"], x)
    xr = x + (xs - x) * common.per_cohort(params["cm_mu_r"], x)
    if tp is not None and params["cm_wk"].shape[-1] < cfg.d_ff:
        k = torch.square(F.relu(mm(comm_mod.copy_to_model(xk, tp),
                                   params["cm_wk"])))
        kv = common.row_linear(k, params["cm_wv"], tp)
    else:
        kv = mm(torch.square(F.relu(mm(xk, params["cm_wk"]))),
                params["cm_wv"])
    if tp is not None and params["cm_wr"].shape[-2] < x.shape[-1]:
        rr = common.row_linear(common.own_block(xr, tp), params["cm_wr"], tp)
    else:
        rr = mm(xr, params["cm_wr"])
    return torch.sigmoid(rr) * kv, x[..., -1, :]


def rwkv_block(params: Params, x: torch.Tensor, norm1: Params, norm2: Params,
               state: Dict[str, torch.Tensor], cfg: ModelConfig, tp=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-LN residual block: time-mix + channel-mix.

    state: {"S": (..., B, H, hd, hd), "x_tm": (..., B, d), "x_cm": (..., B, d)}.
    """
    h = common.apply_norm(x, norm1, cfg)
    att, new_S, new_x_tm = time_mix(params, h, state["S"], state["x_tm"], cfg,
                                    tp)
    x = x + att.to(x.dtype)
    h = common.apply_norm(x, norm2, cfg)
    cm, new_x_cm = channel_mix(params, h, state["x_cm"], cfg, tp)
    x = x + cm.to(x.dtype)
    return x, {"S": new_S, "x_tm": new_x_tm, "x_cm": new_x_cm}


def init_rwkv_state(batch: Union[int, Tuple[int, ...]], cfg: ModelConfig,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device = None) -> Dict[str, torch.Tensor]:
    """Zeros; ``batch`` an int, or the leading dims (C, B) of a stacked
    call."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {"S": torch.zeros(lead + (H, hd, hd), device=device),
            "x_tm": torch.zeros(lead + (d,), dtype=dtype, device=device),
            "x_cm": torch.zeros(lead + (d,), dtype=dtype, device=device)}
