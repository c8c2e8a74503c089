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
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
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


def _ddlerp(params: Params, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Per-token mix coefficients -> the 5 mixed inputs (..., B, S, 5, d),
    float32 (``mu_base`` promotes)."""
    delta = xs - x
    base_mix = params["mu_base"]                                # (.., 5, d)
    mixed0 = x + delta * common.per_cohort(base_mix[..., 0, :], x)
    z = torch.tanh(common.promoted_linear(mixed0, params["ddlerp_A"]))
    z = z.reshape(*z.shape[:-1], MIXES, DDLERP_RANK)            # (.., B,S,5,R)
    dyn = torch.einsum("...bsmr,...mrd->...bsmd", z,
                       params["ddlerp_B"].to(z.dtype))
    mix = common.per_cohort(base_mix, dyn, 2) + dyn             # (.., B,S,5,d)
    return x[..., None, :] + delta[..., None, :] * mix


def time_mix(params: Params, x: torch.Tensor, state_S: torch.Tensor,
             x_prev: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., B, S, d); state_S (..., B, H, hd, hd) float32; x_prev
    (..., B, d).  Returns (out (..., B, S, d) float32, new S, new x_prev)."""
    *lead, S, d = x.shape
    H = cfg.n_heads
    hd = d // H
    mm = common.promoted_linear
    mixed = _ddlerp(params, x, _shift(x, x_prev))
    xr, xk, xv, xw, xg = mixed.unbind(-2)

    def heads(t):
        return t.reshape(*lead, S, H, hd).float()

    r = heads(mm(xr, params["w_r"]))
    k = heads(mm(xk, params["w_k"]))
    v = heads(mm(xv, params["w_v"]))
    g = F.silu(mm(xg, params["w_g"]))
    decay = common.per_cohort(params["decay_base"], xw) + mm(
        torch.tanh(mm(xw, params["decay_A"])), params["decay_B"])
    w = torch.exp(-torch.exp(decay.float())).reshape(*lead, S, H, hd)
    u = common.per_cohort(params["bonus_u"], state_S[..., 0], 2)  # (.., H, hd)

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
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(*lead, S, d)
    y = y * common.per_cohort(params["ln_x_scale"], y)
    out = mm(y.to(x.dtype) * g, params["w_o"])
    return out, S_prev, x[..., -1, :]


def channel_mix(params: Params, x: torch.Tensor, x_prev: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (..., B, S, d) float32, new x_prev)."""
    mm = common.promoted_linear
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * common.per_cohort(params["cm_mu_k"], x)
    xr = x + (xs - x) * common.per_cohort(params["cm_mu_r"], x)
    k = torch.square(F.relu(mm(xk, params["cm_wk"])))
    out = torch.sigmoid(mm(xr, params["cm_wr"])) * mm(k, params["cm_wv"])
    return out, x[..., -1, :]


def rwkv_block(params: Params, x: torch.Tensor, norm1: Params, norm2: Params,
               state: Dict[str, torch.Tensor], cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-LN residual block: time-mix + channel-mix.

    state: {"S": (..., B, H, hd, hd), "x_tm": (..., B, d), "x_cm": (..., B, d)}.
    """
    h = common.apply_norm(x, norm1, cfg)
    att, new_S, new_x_tm = time_mix(params, h, state["S"], state["x_tm"], cfg)
    x = x + att.to(x.dtype)
    h = common.apply_norm(x, norm2, cfg)
    cm, new_x_cm = channel_mix(params, h, state["x_cm"])
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
