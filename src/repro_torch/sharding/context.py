"""Logical axis names resolved to mesh axes: the reference's
``repro.sharding.context`` over the port's mesh (a dict of axis name ->
size).

``resolve_logical(mesh, "vocab", V)`` gives the mesh axes a dim of size V
named "vocab" shards over, honouring divisibility (None: replicate);
``use_sharding_rules(mesh, overrides)`` makes a mesh and its rules
current for a block of code (``current_mesh``, ``current_rules``).

The reference's ``shard(x, *logical)`` is a ``with_sharding_constraint``
that steers GSPMD's propagation through its model code.  The port has no
propagation to steer: its distributed round places every tensor
explicitly (``sharding.rules`` for the parameters, the cohort split for
the batch, the tensor-parallel forward's collectives over "model" for the
activations), so there is nothing to constrain and no such call.  The
tensor-parallel forward reads the logits' vocabulary placement from
``resolve_logical(mesh, "vocab", V)`` and checks it against the head's
spec (the embedding's where tied).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Mapping, Optional, Tuple, Union

Mesh = Mapping[str, int]

_state = threading.local()

# logical name -> tuple of physical mesh axes to try (in order)
DEFAULT_RULES = {
    "batch": (("pod", "data"), ("data",)),
    "seq": (("data",),),          # sequence-parallel decode (long_500k)
    "tensor": (("model",),),
    "expert": (("model",),),
    "fsdp": (("data",),),
    "vocab": (("model",),),
}


def resolve_logical(mesh: Mesh, logical: Optional[str], dim_size: int
                    ) -> Union[None, str, Tuple[str, ...]]:
    """Logical axis -> physical axes (or None), honouring divisibility."""
    if logical is None:
        return None
    for candidate in current_rules().get(logical, ()):
        phys = tuple(a for a in candidate if a in mesh)
        if not phys:
            continue
        if dim_size % math.prod(mesh[a] for a in phys) == 0:
            return phys if len(phys) > 1 else phys[0]
    return None  # replicate


@contextlib.contextmanager
def use_sharding_rules(mesh: Optional[Mesh], overrides: Optional[dict] = None):
    """Activate logical->physical rules. ``overrides`` patches DEFAULT_RULES,
    e.g. {"batch": ((("pod", "data", "model"),), ...)} for dp-over-model."""
    prev = getattr(_state, "mesh", None)
    prev_rules = getattr(_state, "rules", None)
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(overrides or {}))
    try:
        yield
    finally:
        _state.mesh = prev
        _state.rules = prev_rules


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", None) or DEFAULT_RULES
