"""The reference's meshes as axis sizes, with no device state.

A mesh is an ordered dict of axis name -> size.  The cohort axes
(``fl.cohort_axes`` found on the mesh) give the cohort round's
``axis_sizes``.  The round runs in one of two forms:

* stacked (``core.fl.make_fl_round``): every cohort of the mesh on one
  device, the cohorts the leading dimension of every tensor;
* one process a mesh position (``core.fl.make_dist_fl_round`` over
  ``core.comm.Comm``): rank r sits at the mesh coordinates of r, row-major
  in mesh order, and holds the cohort at its coordinates on the cohort
  axes only (``core.comm.coords``, ``core.comm.cohort_index``).

Stacked, the "model" axis runs unsharded.  One process a position, the
ranks that differ only on "model" hold their cohort's model as
``sharding.rules`` places it (``sharding.placement``): the dense decoders,
the MoE, MLA and the encoder-decoder tensor-parallel, each rank its
blocks of the sharded leaves; where the
rules shard no leaf (the QNN, ``train.dp_over_model``), replicas.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

Mesh = Dict[str, int]


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    return {a: int(s) for a, s in zip(axes, shape)}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips a pod; multi_pod adds the 2-pod axis (512)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_debug_mesh(devices: int = 8) -> Mesh:
    """Small mesh: (devices//4, 4) over (data, model)."""
    if devices % 4:
        raise ValueError(f"the debug mesh needs a multiple of 4 devices, "
                         f"got {devices}")
    return make_mesh((devices // 4, 4), ("data", "model"))


def mesh_for_devices(n: int) -> Mesh:
    """The mesh the reference's trainer builds for n devices."""
    if n >= 512:
        return make_production_mesh(multi_pod=True)
    if n >= 256:
        return make_production_mesh()
    if n >= 4:
        return make_debug_mesh(n - n % 4)
    return make_mesh((1, 1), ("data", "model"))


def cohort_axis_sizes(mesh: Mesh, cohort_axes: Sequence[str]
                      ) -> Tuple[int, ...]:
    """Sizes of the cohort axes found on the mesh, in ``cohort_axes``
    order (the reference's ``fl_data_axes``)."""
    return tuple(mesh[a] for a in cohort_axes if a in mesh)
