"""A model placed on one rank of the distributed round: its leaves split
as ``sharding.rules`` says over the mesh's "model" axis.

``place_model(model, config, comm)`` returns the model itself where the
rules shard no leaf over "model" (one model rank, the QNN, whose leaves
match no rule, ``train.dp_over_model``): its model ranks are replicas.
Otherwise it returns a copy whose ``param_shapes`` is the rank's local
layout (``convert.local_layout``), whose ``placement`` (:class:`Placement`)
maps whole leaves and wire vectors to the rank's blocks, and whose ``tp``
is the ``core.comm.Comm`` its tensor-parallel forward reduces over (the
model group: Megatron's f and g, ``comm.copy_to_model`` and
``comm.reduce_from_model``).  The forward reads the placement from the
leaves' shapes and ``tp.model_index``.

Every family has a tensor-parallel forward: the dense decoders
(families "dense" and "vlm"), the MoE (expert parallelism, or the
experts' ff columns where E does not divide the model axis; deepseek-v3's
MLA, shared expert and multi-token block), the encoder-decoder
(whisper), RWKV-6 and the Griffin hybrid.  ``train.zero_over_model``
(parameters model-sharded while the batch is too, gathered per use)
raises ``NotImplementedError`` naming ROADMAP A.6.  Nothing falls back to
whole replicas.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from repro_torch import convert
from repro_torch.core.comm import coords
from repro_torch.sharding import rules
from repro_torch.sharding.context import resolve_logical


@dataclass(frozen=True)
class Placement:
    """One rank's share of a model: the mesh, the rank's coordinates on
    it, every leaf's spec, and the whole and local layouts."""
    mesh: Mapping[str, int]
    coords: Mapping[str, int]
    specs: Mapping[str, rules.Spec]
    full: convert.Layout
    local: convert.Layout

    def block(self, path: str, x: torch.Tensor, *,
              layer: bool = False) -> torch.Tensor:
        """The rank's block of leaf ``path`` given whole (``layer``: one
        layer of a layer-stacked leaf, its leading dim gone)."""
        spec = self.specs[path]
        return convert.take_block(x, spec[1:] if layer else spec, self.mesh,
                                  self.coords)

    def local_layer(self, path: str, i: int) -> Optional[int]:
        """Layer ``i`` of layer-stacked leaf ``path`` in the rank's block:
        its index there, or None where the rules shard the layer dim and
        another model rank holds it."""
        if rules.model_dim(self.specs[path]) != 0:
            return i
        n = self.full[path][0] // self.mesh["model"]
        i -= self.coords["model"] * n
        return i if 0 <= i < n else None

    def take_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A wire vector (..., D) over every leaf in leaf order -> the
        rank's entries (..., D_local), its blocks in leaf order."""
        lead, parts, off = x.shape[:-1], [], 0
        for path, shape in self.full.items():
            n = math.prod(shape)
            leaf = x[..., off:off + n].reshape(*lead, *shape)
            parts.append(convert.take_block(leaf, self.specs[path], self.mesh,
                                            self.coords).reshape(*lead, -1))
            off += n
        return torch.cat(parts, -1)


def gather_block(model, path: str, block: torch.Tensor) -> torch.Tensor:
    """The whole leaf ``path`` from this rank's ``block`` of ``model``: an
    all-gather over its model group where the placement shards the leaf
    (every rank of the group calls it, leaf for leaf), else the block."""
    if model.placement is None:
        return block
    spec = model.placement.specs[path]
    if rules.model_dim(spec) is None:
        return block
    return convert.gather_leaf(model.tp.model_gather(block.contiguous()),
                               spec)


def place_model(model, config, comm):
    """``model`` as rank ``comm.rank`` holds it (see the module's doc); a
    model placed already comes back as it is."""
    if comm.model_size == 1 or getattr(model, "placement", None) is not None:
        return model
    name = config.model.name
    if config.train.zero_over_model:
        raise NotImplementedError(
            f"{name}: train.zero_over_model keeps the parameters sharded "
            f"over 'model' while the batch is too, gathered per use; the "
            f"distributed round does not run it yet (ROADMAP A.6)")
    specs = rules.param_specs(model, config, comm.mesh)
    if all(rules.model_dim(s) is None for s in specs.values()):
        return model
    cfg = config.model
    head = specs["embed" if cfg.tie_embeddings else "head"]
    want = resolve_logical(comm.mesh, "vocab", cfg.vocab_size)
    got = "model" if rules.model_dim(head) is not None else None
    if want != got:
        raise ValueError(f"{name}: the logits' vocab placement {want!r} "
                         f"disagrees with the head's spec {head}")
    full = model.param_shapes
    placement = Placement(dict(comm.mesh), coords(comm.mesh, comm.rank),
                          specs, full,
                          convert.local_layout(full, specs, comm.mesh))
    placed = copy.copy(model)
    placed.param_shapes, placed.placement, placed.tp = (placement.local,
                                                        placement, comm)
    return placed
