"""Carry parameters and fleet state between the JAX reference and the port.

Both packages keep the same names and layouts (conv weights HWIO, dense
weights (in, out)), so a conversion is a plain copy through numpy.  The
flat order of a parameter dict is its sorted key order — the JAX pytree
leaf order — so a flat vector means the same in both packages.  Leading
batch dimensions (the K clients of a round) ride in front of each leaf.

A nested tree (the LM's ``{"blocks": {"attn": {"wq": ...}}, ...}``) is
keyed by its leaves' paths joined with "/" (``tree_paths``).  JAX orders a
dict's children by sorted key and empty dicts hold no leaf, so its
``tree_leaves`` order is the paths' order as long as "/" sorts below every
character of a key: keys are letters, digits and "_", all above "/", so
sorting the joined paths sorts first by the top key, then by the next.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Shapes = Dict[str, Tuple[int, ...]]


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in d.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def param_shapes(params: Mapping[str, torch.Tensor],
                 batch_dims: int = 0) -> Shapes:
    """Per-leaf shapes in leaf order, without the leading batch dims."""
    return {k: tuple(params[k].shape[batch_dims:]) for k in sorted(params)}


def flatten_params(params: Mapping[str, torch.Tensor],
                   batch_dims: int = 0) -> torch.Tensor:
    """Concatenate the leaves in leaf order: (*batch, D)."""
    leaves = [params[k] for k in sorted(params)]
    batch = leaves[0].shape[:batch_dims]
    return torch.cat([v.reshape(*batch, -1) for v in leaves], dim=-1)


def unflatten_params(flat: torch.Tensor, shapes: Shapes) -> Dict[str, torch.Tensor]:
    """Views of ``flat`` (*batch, D) with each leaf's shape behind the batch
    dims; ``shapes`` is in leaf order."""
    batch = flat.shape[:-1]
    out, off = {}, 0
    for k in sorted(shapes):
        n = math.prod(shapes[k])
        out[k] = flat[..., off:off + n].reshape(*batch, *shapes[k])
        off += n
    if off != flat.shape[-1]:
        raise ValueError(f"flat width {flat.shape[-1]} != {off} parameters")
    return out


def tree_paths(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict's leaves keyed by their "/"-joined paths; an empty
    dict (a non-parametric norm's) has no leaf."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(tree_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def flat_from_tree(tree: Mapping, dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> torch.Tensor:
    """A nested dict of numpy leaves (the reference's parameters through
    ``np.asarray``) -> the port's flat (D,) vector in leaf order.  A
    bfloat16 leaf (``ml_dtypes.bfloat16``) passes through float32, which
    holds it exactly, and is cast to ``dtype`` on the device."""
    leaves = tree_paths(tree)
    parts = [torch.from_numpy(np.array(leaves[k], np.float32).reshape(-1))
             for k in sorted(leaves)]
    return torch.cat(parts).to(device=resolve_device(device), dtype=dtype)


def fleet_from_numpy(d: Mapping[str, np.ndarray], device: DeviceLike = None):
    """A ``population.fleet.FleetState`` from its fields as numpy arrays
    (a reference ``FleetState``'s ``_asdict()`` through ``np.asarray``):
    the (N,) float32 vectors and the 0-dim int32 ``rr_cursor``."""
    from repro_torch.population.fleet import FleetState

    dev = resolve_device(device)
    out = {}
    for k in FleetState._fields:
        dtype = np.int32 if k == "rr_cursor" else np.float32
        out[k] = torch.tensor(np.asarray(d[k], dtype), device=dev)
    return FleetState(**out)


def fleet_to_numpy(fleet) -> Dict[str, np.ndarray]:
    """A ``FleetState``'s fields as numpy arrays, by name."""
    return {k: v.detach().cpu().numpy() for k, v in fleet._asdict().items()}


def cache_from_reference(cache: Mapping, dtype: torch.dtype = torch.float32,
                         device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The reference's decode cache of a dense LM, ``{"layers": (k, v),
    "kv_pos", "length"}`` through ``np.asarray`` -> the port's ``{"k", "v",
    "kv_pos", "length"}`` (``models.transformer``): k and v (L, B, C, KV,
    hd) in ``dtype`` (a bfloat16 leaf passes through float32, which holds
    it exactly), kv_pos (B, C) and the 0-d length int32."""
    dev = resolve_device(device)
    k, v = cache["layers"]
    out = {name: torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)
           for name, a in (("k", k), ("v", v))}
    for name in ("kv_pos", "length"):
        out[name] = torch.tensor(np.asarray(cache[name], np.int32), device=dev)
    return out


def cache_to_reference(cache: Mapping[str, torch.Tensor]) -> Dict:
    """The port's cache -> the reference's layout of numpy arrays: k and v
    as float32 (cast to the reference's dtype on its side), kv_pos and
    length int32."""
    k, v = (cache[n].detach().float().cpu().numpy() for n in ("k", "v"))
    return {"layers": (k, v),
            "kv_pos": cache["kv_pos"].cpu().numpy().astype(np.int32),
            "length": cache["length"].cpu().numpy().astype(np.int32)}
