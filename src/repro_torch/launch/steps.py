"""Step builders for the trainer and the server.

``make_train_step``: the cohort FL round when the config's cohort axes are
on the mesh (the paper's technique: quantized deltas, Bernoulli drops,
error-aware renormalizing aggregation), else the standard SGD step.  Both
take (params, batch, gen) and return (params, metrics); with a fleet the
FL round takes and returns the ``FleetState`` too.  ``make_prefill_step``
and ``make_decode_step`` give the model's serving entry points, an
encoder-decoder's prefill taking its frames beside the tokens.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import convert
from repro_torch.config.base import Config
from repro_torch.core import fl as fl_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import Mesh, cohort_axis_sizes


def make_standard_train_step(model, config: Config, *,
                             device: DeviceLike = None) -> Callable:
    """Plain SGD step (paper eq. 3 at cohort level) on the flat (D,)
    parameters (``convert.Flat``): each leaf ``w - eta * g`` in its dtype,
    eta rounded to it once, as the reference's ``w - eta *
    g.astype(w.dtype)`` (in float32 rounded once, as XLA contracts it: one
    ``ops.fma_step_`` launch a leaf).  A model that trains quantized (the
    QNN) takes its fake-quant noise from ``gen``, as the reference's takes
    its key.  ``device=None`` means the CUDA device."""
    dev = resolve_device(device)
    fl_mod._full_fp32(dev)

    def step(params: convert.Flat, batch: Dict[str, torch.Tensor],
             gen: Optional[torch.Generator] = None):
        for b in convert.buffers(params):
            if b.device.type != dev.type:
                raise ValueError(f"params on {b.device}, step on {dev}")
        u = None
        if model.quantizes_training:
            u = fl_mod._uniform(gen, params.shape, params.device)
        new = convert.map_buffers(lambda b: b.detach().clone(), params)
        loss, _ = fl_mod.sgd_step_(lambda leaves: model.loss(leaves, batch, u),
                                   new, model.param_shapes,
                                   config.fl.learning_rate)
        return new, {"loss": loss}

    return step


def make_train_step(model, config: Config, mesh: Mesh, *,
                    collective: Optional[str] = None,
                    force_standard: bool = False,
                    device: DeviceLike = None,
                    tap: Optional[Callable] = None,
                    comm=None) -> Tuple[Callable, str]:
    """Returns (step_fn, kind) with kind in {"fl_round", "fleet_fl_round",
    "standard"}.

    ``collective=None`` resolves ``config.quant.wire_format``.  The FL
    round runs the mesh's cohort axes stacked on one device
    (``core.fl.make_fl_round``), or with ``comm`` (a ``core.comm.Comm`` of
    this mesh) one cohort a process (``core.fl.make_dist_fl_round``, on
    ``comm.device``); with ``config.fleet.enabled`` it threads a
    ``population.fleet.FleetState`` — (params, batch, gen, fleet) ->
    (params, metrics, fleet) — and kind is "fleet_fl_round".  ``tap``
    gets each FL round's metrics (``make_fl_round``): a tapped FL step
    takes the keyword ``step``; the standard step has no tap site, and
    has no distributed form (``comm`` with it raises)."""
    kind = "fleet_fl_round" if config.fleet.enabled else "fl_round"
    if comm is not None:
        if force_standard:
            raise ValueError("the distributed mode runs the FL round only")
        return fl_mod.make_dist_fl_round(model, config, comm,
                                         collective=collective, tap=tap), kind
    if not force_standard:
        sizes = cohort_axis_sizes(mesh, config.fl.cohort_axes)
        fl_round = fl_mod.make_fl_round(model, config, sizes,
                                        collective=collective, device=device,
                                        tap=tap)
        if fl_round is not None:
            return fl_round, kind
    return make_standard_train_step(model, config, device=device), "standard"


def make_prefill_step(model, config: Config) -> Callable:
    """(params, tokens[, frames], max_len=0) -> (last logits, cache)."""
    if config.model.is_encoder_decoder:
        return lambda params, tokens, frames, max_len=0: model.prefill(
            params, tokens, frames, max_len=max_len)
    return lambda params, tokens, max_len=0: model.prefill(
        params, tokens, max_len=max_len)


def make_decode_step(model, config: Config) -> Callable:
    """(params, cache, tokens) -> (logits, cache)."""
    return lambda params, cache, tokens: model.decode_step(params, cache,
                                                           tokens)
