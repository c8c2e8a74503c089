"""Parameter placement (divisibility-aware): the reference's
``repro.sharding.rules`` over the port's mesh (an ordered dict of axis
name -> size, ``launch.mesh``) and ``convert.Layout``.

A **spec** is a tuple with one entry per dim of a leaf: None (whole), an
axis name, or a tuple of axis names — the reference's ``PartitionSpec``
without jax, always as long as the leaf's shape.  ``param_specs(model,
config, mesh)`` gives every leaf of ``model.param_shapes`` its spec from
its path name ("blocks/attn/wq" splits on "/" into the names the
reference's ``_path_names`` gives):

* column-parallel mats (wq/wk/wv, w_up, w_gate, …, the head) shard the
  OUTPUT feature dim over ``model``; row-parallel mats (wo, w_down, …)
  shard the INPUT dim;
* attention projections shard only when the head count divides the model
  axis, else replicate (the vLLM-style fallback);
* the embedding shards its vocabulary;
* MoE expert tensors shard the EXPERT dim over ``model`` when E divides
  it, else the ff dim;
* with ``train.fsdp`` the opposite feature dim additionally shards over
  ``data`` (at 1,024 and above, where it divides).

Every rule checks divisibility and falls back to replication.

**What the port stores.**  The distributed round (``core.fl.
make_dist_fl_round``) places each leaf by its "model" entry only: rank
(c, m) holds the m-th of ``mesh["model"]`` equal contiguous blocks along
that dim (``convert.take_block``).  The reference's round body receives
its parameters through the shard_map's ``P()`` in_spec, whole over the
cohort axes, so a "data" entry (``train.fsdp``: chameleon-34b,
deepseek-v3-671b, nemotron-4-340b) is stored whole between rounds too.
:func:`bytes_per_device` reports the reference's figure, with both
entries; under ``train.fsdp`` a rank's bytes exceed it by the "data"
entries' share.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Mesh = Mapping[str, int]
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# path-name classification
COL_PARALLEL = {"wq", "wk", "wv", "w_up", "w_gate", "w_uq", "w_uk", "w_uv",
                "cm_wk", "w_x", "w_a", "w_i", "w_r", "w_k", "w_v", "w_g",
                "ddlerp_A", "decay_A", "head"}
ROW_PARALLEL = {"wo", "w_o", "w_down", "cm_wv", "cm_wr", "w_out", "decay_B",
                "ddlerp_B"}
ATTN_MATS = {"wq", "wk", "wv", "wo"}
REPLICATED = {"router", "mu_base", "decay_base", "bonus_u", "ln_x_scale",
              "cm_mu_k", "cm_mu_r", "conv_w", "conv_b", "b_a", "b_i", "lam",
              "q_norm", "kv_norm", "w_dq", "w_dkv", "proj"}


def _div(n: int, mesh: Mesh, axis: str) -> bool:
    return axis in mesh and n % mesh[axis] == 0


class ParamRules:
    def __init__(self, config, mesh: Mesh):
        self.cfg = config.model
        self.fsdp = config.train.fsdp and "data" in mesh
        self.dp_over_model = config.train.dp_over_model
        self.zero_over_model = config.train.zero_over_model
        self.mesh = mesh
        m = mesh.get("model", 1)
        self.attn_q_ok = self.cfg.n_heads % m == 0
        self.attn_kv_ok = self.cfg.n_kv_heads % m == 0

    def spec_for(self, path: str, shape: Sequence[int]) -> Spec:
        shape = tuple(shape)
        if self.dp_over_model and not self.zero_over_model:
            # params replicate over `model` (it acts as extra DP inside the
            # cohort); only FSDP-over-data sharding may still apply
            return self._fsdp_only(shape) if len(shape) > 1 else (None,) * len(shape)
        # zero_over_model: params STAY model-sharded (TP-style placement)
        return self._spec_tp(path, shape)

    def _spec_tp(self, path: str, shape: Tuple[int, ...]) -> Spec:
        names = tuple(path.split("/"))
        name = names[-1]
        ndim = len(shape)
        mesh = self.mesh
        in_moe = "moe" in names
        whole = (None,) * ndim

        if name.startswith("b") or ndim <= 1 or name in REPLICATED \
           or "norm" in name or "norm1" in names or "norm2" in names \
           or "final_norm" in names or name in ("scale", "bias"):
            return whole

        if name == "embed":
            spec: list = [None] * ndim
            if _div(shape[0], mesh, "model"):
                spec[0] = "model"
            if self.fsdp and _div(shape[1], mesh, "data"):
                spec[1] = "data"
            return tuple(spec)

        if in_moe and name in ("w_gate", "w_up", "w_down"):
            # stacked (L, E, a, b) or (E, a, b)
            e_dim = ndim - 3
            spec = [None] * ndim
            if _div(shape[e_dim], mesh, "model"):
                spec[e_dim] = "model"
            elif name in ("w_gate", "w_up") and _div(shape[-1], mesh, "model"):
                spec[-1] = "model"
            elif name == "w_down" and _div(shape[-2], mesh, "model"):
                spec[-2] = "model"
            if self.fsdp:
                # shard d_model over data on whichever of the last two is free
                d_dim = ndim - 2 if name in ("w_gate", "w_up") else ndim - 1
                if spec[d_dim] is None and _div(shape[d_dim], mesh, "data"):
                    spec[d_dim] = "data"
            return tuple(spec)

        if name in ATTN_MATS and not self.cfg.mla.enabled:
            ok = {"wq": self.attn_q_ok, "wo": self.attn_q_ok,
                  "wk": self.attn_kv_ok, "wv": self.attn_kv_ok}[name]
            if not ok:
                return self._fsdp_only(shape)
        if name in ("w_uq", "w_uk", "w_uv", "wo") and self.cfg.mla.enabled:
            if not self.attn_q_ok:
                return self._fsdp_only(shape)

        if name in COL_PARALLEL:
            return self._matmul_spec(shape, model_dim=-1, fsdp_dim=-2)
        if name in ROW_PARALLEL:
            return self._matmul_spec(shape, model_dim=-2, fsdp_dim=-1)
        return whole

    def _matmul_spec(self, shape, model_dim: int, fsdp_dim: int) -> Spec:
        spec: list = [None] * len(shape)
        if _div(shape[model_dim], self.mesh, "model"):
            spec[model_dim] = "model"
        if self.fsdp and shape[fsdp_dim] >= 1024 and _div(shape[fsdp_dim], self.mesh, "data"):
            spec[fsdp_dim] = "data"
        return tuple(spec)

    def _fsdp_only(self, shape) -> Spec:
        spec: list = [None] * len(shape)
        if self.fsdp and shape[-2] >= 1024 and _div(shape[-2], self.mesh, "data"):
            spec[-2] = "data"
        return tuple(spec)


def param_specs(model, config, mesh: Mesh) -> Dict[str, Spec]:
    """Every leaf's spec by path, in ``model.param_shapes``' leaf order."""
    rules = ParamRules(config, mesh)
    return {path: rules.spec_for(path, shape)
            for path, shape in model.param_shapes.items()}


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over "model" (the only axis the port splits a
    stored leaf along), or None."""
    for d, entry in enumerate(spec):
        if "model" in entry_axes(entry):
            return d
    return None


def bytes_per_device(layout, specs: Mapping[str, Spec], mesh: Mesh) -> int:
    """Analytic per-device parameter bytes under ``specs`` (every entry's
    axes divide a leaf's bytes, as the reference's ``bytes_per_device``);
    ``layout`` a ``convert.Layout`` (each leaf's shape and dtype)."""
    total = 0
    for path, shape in layout.items():
        itemsize = torch.empty((), dtype=layout.dtypes[path]).element_size()
        denom = math.prod(mesh[a] for entry in specs[path]
                          for a in entry_axes(entry))
        total += math.prod(shape) * itemsize // max(denom, 1)
    return total
