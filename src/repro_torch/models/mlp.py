"""MLP blocks: the dense MLP, gated (three matrices) or plain (two), and
the capacity-based mixture of experts.

Weights are (d, ff) matrices for one model or (C, d, ff) for C stacked
cohorts (``common.linear``); the MoE's expert weights are (E, d, ff), or
(C, E, d, ff) stacked.

The MoE is the reference's GShard dense-dispatch formulation: tokens split
into groups of ``MOE_GROUP_SIZE``, routed top-k (the k probabilities
renormalized) with a per-group expert capacity; a token's slot in its
expert's buffer is the running count of earlier picks (a cumulative sum),
and a pick over capacity is dropped (its token keeps the residual path
alone).  Dispatch, expert and combine are plain einsums, as the
reference's are (no Pallas kernel).  The router stays in float32 whatever
the model's dtype, as the reference keeps it.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.models import common

MOE_GROUP_SIZE = 1024
MOE_CAPACITY_FACTOR = 1.25


def mlp_param_shapes(cfg: ModelConfig, d_ff: int = 0
                     ) -> Dict[str, Tuple[int, ...]]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    shapes = {"w_up": (d, ff), "w_down": (ff, d)}
    if cfg.gated_mlp:
        shapes["w_gate"] = (d, ff)
    return shapes


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, *, d_ff: int = 0,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    return {name: common.dense_init(gen, shape, dtype=dtype)
            for name, shape in mlp_param_shapes(cfg, d_ff).items()}


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig, tp=None, d_ff: int = 0) -> torch.Tensor:
    """The MLP of ``d_ff`` columns (default ``cfg.d_ff``); where w_up holds
    one model rank's block of them (tensor parallelism over ``tp``), f at
    the input and w_down row-parallel (``common.row_linear``)."""
    act = common.activation_fn(cfg.activation)
    if tp is not None and params["w_up"].shape[-1] < (d_ff or cfg.d_ff):
        x32 = common.column_input(x, tp)
        up = common.column_linear(x32, params["w_up"])
        if cfg.gated_mlp:
            up = act(common.column_linear(x32, params["w_gate"])) * up
        else:
            up = act(up)
        return common.row_linear(up, params["w_down"], tp)
    up = common.linear(x, params["w_up"])
    if cfg.gated_mlp:
        up = act(common.linear(x, params["w_gate"])) * up
    else:
        up = act(up)
    return common.linear(up, params["w_down"])


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------


def moe_param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The router (d, E), the experts' (E, d, ff) and (E, ff, d) matrices
    and, where configured, the shared experts' MLP under "shared/"."""
    d, m = cfg.d_model, cfg.moe
    ff, E = m.expert_d_ff or cfg.d_ff, m.num_experts
    shapes = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
              "w_down": (E, ff, d)}
    if m.num_shared_experts:
        for k, s in mlp_param_shapes(cfg, ff * m.num_shared_experts).items():
            shapes[f"shared/{k}"] = s
    return shapes


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, *,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    """N(0, 1/fan_in) for every matrix; the router in float32."""
    return dict(iter_moe_params(gen, cfg, dtype=dtype))


def iter_moe_params(gen: torch.Generator, cfg: ModelConfig, *,
                    dtype: torch.dtype = torch.float32
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """:func:`init_moe_params`' leaves one at a time, in its order, each
    drawn when the caller asks for it (a caller that copies each into
    place holds one at a time: deepseek-v3's are 7.5 GB each)."""
    for name, shape in moe_param_shapes(cfg).items():
        yield name, common.dense_init(
            gen, shape, dtype=torch.float32 if name == "router" else dtype)


def moe_capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    cap = int(math.ceil(tokens_per_group * m.experts_per_token
                        / m.num_experts * MOE_CAPACITY_FACTOR))
    return max(cap, 4)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis and their indices, in
    descending order, an equal pair lower index first, as
    ``jax.lax.top_k`` (a stable descending sort; ``torch.topk`` promises
    no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: ModelConfig, capacity: int):
    """Routing of (..., gs, E) router logits (float32): (probs, the chosen
    experts (..., gs, k), their renormalized probabilities, each pick's
    slot in its expert's buffer and whether it fits (..., gs, k))."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, m.experts_per_token)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    sel = F.one_hot(top_e, m.num_experts).float()            # (..., gs, k, E)
    lead, gs, K, E = sel.shape[:-3], *sel.shape[-3:]
    sel_flat = sel.reshape(*lead, gs * K, E)
    pos = torch.cumsum(sel_flat, dim=-2) - 1.0
    pos = (pos * sel_flat).sum(-1).reshape(*lead, gs, K)
    return probs, sel, top_p, pos, pos < capacity


def moe(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), the load-balance loss); or stacked,
    every leaf with a leading C and x (C, B, S, d) -> ((C, B, S, d), (C,)).

    The aux loss is Switch's ``E · Σ_e f_e · P_e · router_aux_loss_coef``:
    f_e the share of picks that chose expert e (before capacity), P_e its
    mean router probability.

    Under tensor parallelism over ``tp`` (read from the experts' local
    shapes) every rank routes the same tokens with the replicated router
    alike.  Where the experts' leaves hold a block of the E experts
    (expert parallelism), the rank dispatches to and combines from its
    experts only, f on ``xf`` ahead of the dispatch product; where they
    hold a block of every expert's ff columns (E does not divide the model
    axis), it runs every expert on its columns, f on the dispatched
    ``xe``.  Either way the combined output is a partial sum (float32),
    summed by g and rounded once, and the router's logits pass through f
    ahead of the gates, so the gates' gradient sums over the model group;
    the aux loss reads the logits before f, its gradient whole on every
    rank.  The shared expert: :func:`_shared_expert`."""
    if params["router"].dim() == 2:
        out, aux = moe({k: v[None] for k, v in params.items()}, x[None], cfg,
                       tp)
        return out[0], aux[0]
    m = cfg.moe
    n, B, S, d = x.shape
    T = B * S
    gs = min(MOE_GROUP_SIZE, T)
    if T % gs:
        raise ValueError(f"{T} tokens do not split into MoE groups of {gs}")
    G, E, K = T // gs, m.num_experts, m.experts_per_token
    ff = m.expert_d_ff or cfg.d_ff
    cap = moe_capacity(gs, cfg)
    El, ffl = params["w_gate"].shape[-3], params["w_gate"].shape[-1]
    split = tp is not None and (El < E or ffl < ff)

    xf = x.reshape(n, G, gs, d)
    logits = common.linear(xf.float(), params["router"])      # (n, G, gs, E)
    routed = comm_mod.copy_to_model(logits, tp) if split else logits
    probs, sel, top_p, pos, keep = route(routed, cfg, cap)
    if split:               # the aux loss reads the logits before f
        probs = torch.softmax(logits, dim=-1)
    gate = top_p * keep
    pos_oh = F.one_hot(torch.where(keep, pos, cap).long(),
                       cap + 1).float()[..., :cap]             # (n,G,gs,k,cap)
    mine = sel
    if El < E:                                  # this rank's experts
        mine = sel[..., tp.model_index * El:(tp.model_index + 1) * El]
    dispatch = torch.einsum("ngtke,ngtkc->ngtec", mine, pos_oh)
    combine = torch.einsum("ngtke,ngtkc,ngtk->ngtec", mine, pos_oh, gate)

    act = common.activation_fn(cfg.activation)
    xin = common.column_input(xf, tp) if El < E else xf
    xe = torch.einsum("ngtec,ngtd->ngecd", dispatch.to(xin.dtype),
                      xin).to(x.dtype)
    if split and El == E:           # every expert on this rank's ff columns
        xe = common.column_input(xe, tp)
    # the products at xe's dtype (float32 after f, as common.column_linear
    # and row_linear take them), h rounded to x's dtype
    w = {k: params[k].to(xe.dtype) for k in ("w_gate", "w_up", "w_down")}
    h = act(torch.einsum("ngecd,nedf->ngecf", xe, w["w_gate"]).to(x.dtype))
    h = h * torch.einsum("ngecd,nedf->ngecf", xe, w["w_up"]).to(x.dtype)
    ye = torch.einsum("ngecf,nefd->ngecd", h.to(xe.dtype), w["w_down"])
    if split:
        # the gates rounded to x's dtype, as the whole product takes them
        out = torch.einsum("ngtec,ngecd->ngtd",
                           combine.to(x.dtype).float(), ye.float())
        out = comm_mod.reduce_from_model(out, tp).to(x.dtype)
    else:
        out = torch.einsum("ngtec,ngecd->ngtd", combine.to(x.dtype), ye)
    shared = {k[len("shared/"):]: v for k, v in params.items()
              if k.startswith("shared/")}
    if shared:
        out = out + _shared_expert(shared, xf, cfg,
                                   ff * m.num_shared_experts, tp)

    if K == 1:
        frac_tokens = sel[..., 0, :].mean(dim=(1, 2))
    else:
        frac_tokens = sel.sum(dim=3).mean(dim=(1, 2)) / K        # (n, E)
    frac_probs = probs.mean(dim=(1, 2))
    aux = E * (frac_tokens * frac_probs).sum(-1) * m.router_aux_loss_coef
    return out.reshape(n, B, S, d), aux


def _shared_expert(params: Dict[str, torch.Tensor], xf: torch.Tensor,
                   cfg: ModelConfig, d_ff: int, tp) -> torch.Tensor:
    """The shared experts' MLP of ``d_ff`` columns on every token.  Its
    leaves column- and row-parallel (w_up's and w_gate's ff columns,
    w_down's ff rows) run as :func:`mlp` does; split otherwise (the rules'
    expert dim of an unstacked shared expert is w_down's output dim, as in
    deepseek's multi-token block), each sharded leaf is gathered whole
    (``comm.gather_from_model``) and the MLP runs whole on every rank on
    the same tokens, its gradient whole, each rank keeping its block."""
    d = cfg.d_model
    if tp is not None and params["w_down"].shape[-1] < d:
        full = {"w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)}
        whole = {}
        for k, v in params.items():
            cut = [i for i in (-2, -1) if v.shape[i] < full[k][i]]
            whole[k] = (comm_mod.gather_from_model(v, tp, v.dim() + cut[0])
                        if cut else v)
        params = whole
    return mlp(params, xf, cfg, tp, d_ff)
