"""Griffin / RecurrentGemma blocks (arXiv:2402.19427): the RG-LRU recurrent
block that the hybrid stack mixes 2:1 with local (sliding-window, MQA)
attention; the reference's ``models/griffin.py`` in PyTorch.

RG-LRU (post-conv input x_t, hidden h_t in R^{d_rnn}):
    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_i x_t + b_i)            input gate
    a_t = exp(−c·softplus(Λ)·r_t),    c = 8
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The gates of the whole sequence run at once, the recurrence is a Python
loop over the tokens where the reference scans.  Every leaf may carry a
leading cohort dimension C, the activations then (C, B, S, d).

**Type promotion** as the reference's: the float32 ``conv_b`` promotes the
convolution's output to float32, so the LRU and ``(y * gate) @ w_out``
run in float32, the weights cast up exactly (``common.promoted_linear``).

Decode state per recurrent layer: {"h": (B, d_rnn) float32,
"conv": (B, width−1, d_rnn)} in the model's dtype.

**Tensor parallelism** (``tp``, a ``core.comm.Comm``; the leaves one
model rank's blocks, ``sharding.placement``).  The rule: f
(``comm.copy_to_model``) goes where a tensor that is whole on every rank
meets a product or a narrowing that differs by rank, and g
(``comm.reduce_from_model``) after a partial sum; a gathered tensor
(``comm.gather_from_model``) is used whole by every rank, else f follows
it.  So: f on x, then ``w_x`` and ``w_gate`` column-parallel (the rank's
d_rnn channels); the depthwise convolution on those channels,
``conv_w`` and ``conv_b`` narrowed through f; the post-conv u gathered
whole and taken through f for ``w_a``'s and ``w_i``'s columns (each rank
reads all of u with its own columns: the gather's backward is then a
reduce-scatter), ``b_a``, ``b_i`` and ``lam`` narrowed through f; the
LRU's scan on the rank's channels, with its own block of u; ``w_out``
row-parallel (g).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.models import common

LRU_C = 8.0

#: the leaves the reference's init keeps in float32 whatever the model's
#: dtype
FLOAT32 = frozenset({"conv_b", "b_a", "b_i", "lam"})

Params = Dict[str, torch.Tensor]


def recurrent_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    dr = cfg.recurrent.d_rnn or d
    w = cfg.recurrent.conv1d_width
    return {"w_x": (d, dr), "w_gate": (d, dr), "conv_w": (w, dr),
            "conv_b": (dr,), "w_a": (dr, dr), "b_a": (dr,), "w_i": (dr, dr),
            "b_i": (dr,), "lam": (dr,), "w_out": (dr, d)}


def init_recurrent_params(gen: torch.Generator, cfg: ModelConfig, *,
                          dtype: torch.dtype = torch.float32) -> Params:
    """The matrices N(0, 1/fan_in) in ``dtype`` (``conv_w`` times 0.1), the
    biases 0 and ``lam`` 2 in float32 (softplus(2): a stable decay); the
    draws are the port's own."""
    out = {}
    for name, shape in recurrent_param_shapes(cfg).items():
        if name in FLOAT32:
            out[name] = torch.full(shape, 2.0 if name == "lam" else 0.0,
                                   device=gen.device)
        else:
            w = common.dense_init(gen, shape, dtype=dtype)
            out[name] = w * 0.1 if name == "conv_w" else w
    return out


def _causal_conv(u: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 u_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. u (..., B, S, dr); u_prev (..., B, w−1, dr)
    the history.  Returns (the output, float32 where ``conv_b`` is; the
    new history)."""
    w, S = conv_w.shape[-2], u.shape[-2]
    ext = torch.cat([u_prev.to(u.dtype), u], dim=-2)           # (.., S+w-1, dr)
    out = sum(ext[..., i:i + S, :] * common.per_cohort(conv_w[..., i, :], u)
              for i in range(w))
    return out + common.per_cohort(conv_b, u), ext[..., S:, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x) with no threshold (``F.softplus``
    returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _rg_lru(params: Params, x: torch.Tensor, h0: torch.Tensor, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., B, S, dr); h0 (..., B, dr) float32.  Returns (y (..., B, S,
    dr) in x's dtype, h_final).  Under ``tp`` with ``w_a`` split, x, h0 and
    the outputs are the rank's channels."""
    mm = common.promoted_linear
    x32 = x.float()
    b_a, b_i, lam = params["b_a"], params["b_i"], params["lam"]
    xin = x32
    if tp is not None and params["w_a"].shape[-1] < params["w_a"].shape[-2]:
        xin = comm_mod.copy_to_model(
            comm_mod.gather_from_model(x32, tp, -1), tp)
        b_a, b_i, lam = (common.own_block(t, tp) for t in (b_a, b_i, lam))
    r = torch.sigmoid(mm(xin, params["w_a"]) + common.per_cohort(b_a, x))
    i = torch.sigmoid(mm(xin, params["w_i"]) + common.per_cohort(b_i, x))
    log_a = -LRU_C * common.per_cohort(_softplus(lam), x) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * x32)

    # one launch a token; each of a and gated unbound once (its backward
    # stacks the tokens' gradients in one write)
    h, ys = h0, []
    for a_t, g_t in zip(a.unbind(-2), gated.unbind(-2)):
        h = torch.addcmul(g_t, a_t, h)
        ys.append(h)
    return torch.stack(ys, dim=-2).to(x.dtype), h


def recurrent_block(params: Params, x: torch.Tensor,
                    state: Dict[str, torch.Tensor], cfg: ModelConfig, tp=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Griffin recurrent block. x (..., B, S, d).  Returns (out, float32
    where the weights are not; the new state).  Under ``tp`` with ``w_x``
    split the (whole) state is narrowed to the rank's channels, and the
    new state is theirs."""
    dr = cfg.recurrent.d_rnn or cfg.d_model
    if tp is None or params["w_x"].shape[-1] == dr:
        gate = F.gelu(common.linear(x, params["w_gate"]), approximate="tanh")
        u = common.linear(x, params["w_x"])
        u, new_conv = _causal_conv(u, params["conv_w"], params["conv_b"],
                                   state["conv"])
        y, new_h = _rg_lru(params, u, state["h"])
        out = common.promoted_linear(y * gate, params["w_out"])
        return out, {"h": new_h, "conv": new_conv}
    x32 = common.column_input(x, tp)
    gate = F.gelu(common.column_linear(x32, params["w_gate"]),
                  approximate="tanh")
    u = common.column_linear(x32, params["w_x"])
    n = u.shape[-1]
    own = lambda t: t.narrow(-1, tp.model_index * n, n)
    u, new_conv = _causal_conv(u, common.own_block(params["conv_w"], tp),
                               common.own_block(params["conv_b"], tp),
                               own(state["conv"]))
    y, new_h = _rg_lru(params, u, own(state["h"]), tp)
    out = common.row_linear(y * gate, params["w_out"], tp)
    return out, {"h": new_h, "conv": new_conv}


def init_recurrent_state(batch: Union[int, Tuple[int, ...]], cfg: ModelConfig,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device = None
                         ) -> Dict[str, torch.Tensor]:
    """Zeros; ``batch`` an int, or the leading dims (C, B) of a stacked
    call."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    dr = cfg.recurrent.d_rnn or cfg.d_model
    w = cfg.recurrent.conv1d_width
    return {"h": torch.zeros(lead + (dr,), device=device),
            "conv": torch.zeros(lead + (w - 1, dr), dtype=dtype,
                                device=device)}
