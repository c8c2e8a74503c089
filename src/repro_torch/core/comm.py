"""The mesh's collectives across processes: ``torch.distributed`` in the
place of the reference's ``lax.psum``, ``lax.ppermute`` and
``lax.axis_index`` inside ``shard_map`` (``src/repro/core/fl.py``,
``src/repro/core/aggregation.py``).

One process a mesh position (a "rank"): rank r sits at the mesh
coordinates of r, row-major in mesh order (:func:`coords`), and holds the
cohort at its coordinates on the cohort axes only (:func:`cohort_index`);
the ranks that differ only on "model" hold that cohort's model split
tensor-parallel (``sharding``), or replicas of it where the rules shard
no leaf.  :class:`Comm`, built once from the mesh (an ordered dict of
axis name -> size, as ``launch.mesh`` makes) and the rank, holds:

  ``psum`` / ``pmean``  an ``all_reduce`` over the cohort axes: within the
                        rank's group of ranks that differ only there (one
                        group a replica position);
  ``gather``            an ``all_gather`` over the same group, stacked in
                        cohort order;
  ``hop`` / ``forward`` the ring along one cohort axis: send to the rank at
                        index + 1 and receive from index - 1
                        (``batch_isend_irecv``), as the reference's
                        ``perm = [(j, (j + 1) % K)]``; ``forward`` passes
                        one payload on K - 1 times;
  ``axis_index``        the rank's index on a cohort axis;
  ``model_all_reduce``  over the model group (the ranks that differ only
                        on "model", in model order): a sum (``op`` "sum",
                        a floating payload summed in float32 and rounded
                        once to its dtype), "max" or "min";
  ``model_gather``      every model rank's block, in model order.

:func:`copy_to_model` and :func:`reduce_from_model` are Megatron's f and g
over the model group: f the identity forward and a sum all-reduce of the
gradient backward (at a column-parallel product's input), g a sum
all-reduce forward and the identity backward (at a row-parallel product's
output).  Without a model group both are the identity.

Every subgroup is made with ``dist.new_group`` on every rank, in one order
(the cohort groups, then the model groups; a rank that skipped one would
deadlock the others), and the process group, every subgroup and every
wait time out after ``TIMEOUT_S``, so a rank that hangs fails its peers.

The backend is named by the caller, never chosen here:

  "nccl"  each rank on its own card.  :func:`init_process_group` raises,
          naming "gloo", where two ranks name one device or a rank names
          no card: NCCL takes one rank a card in a communicator.
  "gloo"  on the CPU, and for several ranks sharing one card.  Gloo's send
          and recv take no CUDA tensors, so under gloo every CUDA payload is
          **staged through pinned host memory**: copied to the host once
          the device has produced it, moved by gloo, and copied back to the
          device without blocking.  ``forward`` keeps the payload it passes
          on in host memory and alternates two receive buffers, so hop h+1's
          receive never overwrites a buffer before hop h's copy to the
          device has landed (a CUDA event a buffer).  ``staging_s`` sums
          the host seconds the copies take.  CPU tensors (and every tensor
          under "nccl") go to the backend as they are.

Nothing falls back: a failed collective raises, and no payload moves to
the CPU but through the staging above.
"""
from __future__ import annotations

import math
import time
from datetime import timedelta
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import convert

BACKENDS = ("gloo", "nccl")
TIMEOUT_S = 300.0

Mesh = Dict[str, int]


# -- ranks on the mesh ---------------------------------------------------------

def coords(mesh: Mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each mesh axis, row-major in mesh order."""
    size = math.prod(mesh.values())
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} is outside a mesh of {size}")
    out = {}
    for a in reversed(list(mesh)):
        rank, out[a] = divmod(rank, mesh[a])
    return {a: out[a] for a in mesh}


def rank_at(mesh: Mesh, where: Dict[str, int]) -> int:
    """The rank at mesh coordinates ``where`` (every axis named)."""
    r = 0
    for a, s in mesh.items():
        r = r * s + where[a]
    return r


def cohort_index(mesh: Mesh, rank: int, cohort_axes: Sequence[str]) -> int:
    """The flat cohort index of ``rank`` over the cohort axes only,
    row-major in ``cohort_axes`` order: the stacked round's row, shared by
    every replica of the cohort (the reference's ``_cohort_index``, not its
    ``_flat_shard`` over every axis)."""
    at = coords(mesh, rank)
    c = 0
    for a in cohort_axes:
        if a in mesh:
            c = c * mesh[a] + at[a]
    return c


def groups_over(mesh: Mesh, axes: Sequence[str]) -> List[List[int]]:
    """The rank groups that differ only on ``axes``: one group for each
    position on the other axes, in rank order; each group's ranks ordered
    row-major over ``axes`` (in the order given)."""
    axes = [a for a in axes if a in mesh]
    rest = [a for a in mesh if a not in axes]
    groups = []
    for fixed in range(math.prod(mesh[a] for a in rest)):
        at = {}
        for a in reversed(rest):
            fixed, at[a] = divmod(fixed, mesh[a])
        group = []
        for i in range(math.prod(mesh[a] for a in axes)):
            for a in reversed(axes):
                i, at[a] = divmod(i, mesh[a])
            group.append(rank_at(mesh, at))
        groups.append(group)
    return groups


def axis_groups(mesh: Mesh, axis: str) -> List[List[int]]:
    """The rank groups along one axis: each group's ranks by index on it."""
    return groups_over(mesh, (axis,))


# -- the process group ---------------------------------------------------------


def _device_name(device) -> str:
    d = torch.device(device)
    if d.type == "cuda":
        return f"cuda:{d.index or 0}"
    return str(d)


def check_nccl_devices(devices: Sequence[str]) -> None:
    """Raise unless every rank names its own card (NCCL's rule)."""
    seen: Dict[str, int] = {}
    for r, d in enumerate(devices):
        if not d.startswith("cuda"):
            raise ValueError(f"backend 'nccl' needs a card a rank; rank {r} "
                             f"is on {d}: use backend 'gloo'")
        if d in seen:
            raise ValueError(f"ranks {seen[d]} and {r} share {d}, and NCCL "
                             f"takes one rank a card: run ranks that share a "
                             f"card with backend 'gloo' (host staging)")
        seen[d] = r


def init_process_group(backend: str, rank: int, world_size: int, device, *,
                       init_method: str = "env://") -> None:
    """Join the default process group: rendezvous at ``init_method``
    ("env://" reads what ``torchrun`` sets; "file://PATH" a ``FileStore``),
    and under "nccl" first check through the store that no two ranks share
    a card.  Every collective of the group times out after ``TIMEOUT_S``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    timeout = timedelta(seconds=TIMEOUT_S)
    store, rank, world_size = next(dist.rendezvous(
        init_method, rank, world_size, timeout=timeout))
    if backend == "nccl":
        store.set(f"repro_torch/device/{rank}", _device_name(device))
        check_nccl_devices([store.get(f"repro_torch/device/{r}").decode()
                            for r in range(world_size)])
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size, timeout=timeout)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class Comm:
    """The collectives of one rank of ``mesh`` over its cohort axes (the
    names of ``cohort_axes`` found on the mesh, in that order).  Payloads
    live on ``device``.  ``sent`` counts the payload bytes this rank handed
    to each kind of collective (an all-reduce's input once, a hop's
    message, a gather's part, a broadcast's buffers on its source)."""

    def __init__(self, mesh: Mesh, cohort_axes: Sequence[str], device):
        if not dist.is_initialized():
            raise RuntimeError("join the process group first "
                               "(comm.init_process_group)")
        self.mesh = dict(mesh)
        self.rank = dist.get_rank()
        world = math.prod(self.mesh.values())
        if dist.get_world_size() != world:
            raise ValueError(f"mesh {self.mesh} has {world} positions, the "
                             f"group {dist.get_world_size()} ranks")
        self.axes = tuple(a for a in cohort_axes if a in self.mesh)
        if not self.axes:
            raise ValueError(f"no cohort axis of {tuple(cohort_axes)} on the "
                             f"mesh {self.mesh}")
        self.axis_sizes = tuple(self.mesh[a] for a in self.axes)
        self.num_cohorts = math.prod(self.axis_sizes)
        self.cohort = cohort_index(self.mesh, self.rank, self.axes)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._timeout = timedelta(seconds=TIMEOUT_S)
        at = coords(self.mesh, self.rank)
        self._index = {a: at[a] for a in self.axes}
        # (next, previous) rank on each cohort axis's ring
        self._peers: Dict[str, Tuple[int, int]] = {}
        for a in self.axes:
            ring = next(g for g in axis_groups(self.mesh, a)
                        if self.rank in g)
            i, k = ring.index(self.rank), len(ring)
            self._peers[a] = (ring[(i + 1) % k], ring[(i - 1) % k])
        # every rank makes every group, in the same order: the cohort
        # groups, then the model groups
        self.group = None
        for ranks in groups_over(self.mesh, self.axes):
            g = dist.new_group(ranks, timeout=self._timeout)
            if self.rank in ranks:
                self.group, members = g, ranks
        # all_gather returns the parts in ascending global rank: the slot
        # of each in cohort order
        self._slots = [members.index(r) for r in sorted(members)]
        self._root = members[0]
        self.model_size = (self.mesh.get("model", 1)
                           if "model" not in self.axes else 1)
        self.model_index = at.get("model", 0) if self.model_size > 1 else 0
        self.model_group = None
        if self.model_size > 1:
            for ranks in groups_over(self.mesh, ("model",)):
                g = dist.new_group(ranks, timeout=self._timeout)
                if self.rank in ranks:
                    self.model_group, model_members = g, ranks
            self._model_slots = [model_members.index(r)
                                 for r in sorted(model_members)]
        self.sent = {"psum": 0, "hop": 0, "gather": 0, "broadcast": 0,
                     "model": 0}
        self.staging_s = 0.0
        self.model_staging_s = 0.0

    # -- host staging (gloo with CUDA tensors) ---------------------------------

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """x copied into pinned host memory, once the device has made it."""
        stream = torch.cuda.current_stream(self.device)
        stream.synchronize()
        t0 = time.perf_counter()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        stream.synchronize()
        self.staging_s += time.perf_counter() - t0
        return host

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A device copy of a pinned host tensor, queued without waiting."""
        t0 = time.perf_counter()
        out = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        out.copy_(host, non_blocking=True)
        self.staging_s += time.perf_counter() - t0
        return out

    def _wait(self, works) -> None:
        for w in works:
            w.wait(timeout=self._timeout)

    # -- collectives ----------------------------------------------------------

    def axis_index(self, axis: str) -> int:
        return self._index[axis]

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the cohorts (a new tensor).  The order of
        a float sum is the backend's; an int32 sum wraps modulo 2^32."""
        buf = self._to_host(x) if self.staged else x.contiguous().clone()
        dist.all_reduce(buf, group=self.group)
        self.sent["psum"] += buf.nbytes
        return self._to_device(buf) if self.staged else buf

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.num_cohorts

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every cohort's ``x`` stacked in cohort order, (C, *x.shape)."""
        src = self._to_host(x) if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in self._slots]
        dist.all_gather(parts, src, group=self.group)
        self.sent["gather"] += src.nbytes
        out = torch.stack([parts[self._slots.index(c)]
                           for c in range(len(parts))])
        return self._to_device(out.pin_memory()) if self.staged else out

    def _post(self, send: torch.Tensor, recv: torch.Tensor, axis: str):
        nxt, prv = self._peers[axis]
        return dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt),
                                       dist.P2POp(dist.irecv, recv, prv)])

    def hop(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """One ring hop along ``axis``: ``x`` goes to the rank at index + 1,
        and the payload of the rank at index - 1 comes back."""
        send = self._to_host(x) if self.staged else x.contiguous()
        recv = torch.empty(send.shape, dtype=send.dtype,
                           pin_memory=self.staged, device=send.device)
        self._wait(self._post(send, recv, axis))
        self.sent["hop"] += send.nbytes
        return self._to_device(recv) if self.staged else recv

    def forward(self, x: torch.Tensor, axis: str, *,
                pipelined: bool) -> Iterator[torch.Tensor]:
        """Pass ``x`` on around the ring of ``axis``: yields, for t = 1 ..
        K - 1, the payload of the rank t steps back (each hop forwards what
        the last one brought).  ``pipelined`` posts hop t + 1 before
        yielding hop t's payload, so its transfer runs while the caller
        consumes it; either way the same payloads come in the same order."""
        K = self.mesh[axis]
        first = self._to_host(x) if self.staged else x.contiguous()
        bufs = ([torch.empty(first.shape, dtype=first.dtype, pin_memory=True)
                 for _ in range(2)] if self.staged else None)
        landed: List[Optional[torch.cuda.Event]] = [None, None]

        def post(send: torch.Tensor, t: int):
            # hop t receives into buffer t mod 2 once hop t-2's copy landed
            if bufs is None:
                recv = torch.empty_like(send)
            else:
                if landed[t % 2] is not None:
                    t0 = time.perf_counter()
                    landed[t % 2].synchronize()
                    self.staging_s += time.perf_counter() - t0
                recv = bufs[t % 2]
            return recv, self._post(send, recv, axis)

        recv, works = post(first, 1)
        for t in range(1, K):
            self._wait(works)
            self.sent["hop"] += recv.nbytes
            cur = recv
            if pipelined and t < K - 1:
                recv, works = post(cur, t + 1)
            if bufs is None:
                yield cur
            else:
                out = self._to_device(cur)
                landed[t % 2] = torch.cuda.Event()
                landed[t % 2].record(torch.cuda.current_stream(self.device))
                yield out
            if not pipelined and t < K - 1:
                recv, works = post(cur, t + 1)

    def broadcast_(self, flat: convert.Flat) -> convert.Flat:
        """The flat parameters of the first rank of this rank's cohort group
        (cohort 0 at its model index) into every rank of the group, buffer
        by buffer (one a dtype), in place; returns ``flat``."""
        for b in convert.buffers(flat):
            buf = self._to_host(b) if self.staged else b
            dist.broadcast(buf, src=self._root, group=self.group)
            if self.rank == self._root:
                self.sent["broadcast"] += buf.nbytes
            if self.staged:
                b.copy_(buf)
        return flat

    # -- the model group ------------------------------------------------------

    def model_all_reduce(self, x: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
        """``x`` reduced over the model group (a new tensor; ``x`` itself
        without one): "sum" (a floating ``x`` summed in float32, rounded
        once to its dtype), "max" or "min".  Every rank of the group gets
        the same values."""
        if self.model_group is None:
            return x
        staged0 = self.staging_s
        red = x.detach()
        if op == "sum" and red.is_floating_point():
            red = red.to(torch.float32)
        buf = self._to_host(red) if self.staged else red.contiguous().clone()
        dist.all_reduce(buf, op=_OPS[op], group=self.model_group)
        self.sent["model"] += buf.nbytes
        out = self._to_device(buf) if self.staged else buf
        self.model_staging_s += self.staging_s - staged0
        return out.to(x.dtype)

    def model_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every model rank's ``x`` (of one shape), in model order."""
        if self.model_group is None:
            return [x]
        staged0 = self.staging_s
        src = self._to_host(x) if self.staged else x.contiguous()
        parts = [torch.empty_like(src) for _ in self._model_slots]
        dist.all_gather(parts, src, group=self.model_group)
        self.sent["model"] += src.nbytes
        out = [parts[self._model_slots.index(m)] for m in range(len(parts))]
        if self.staged:
            out = [self._to_device(p) for p in out]
        self.model_staging_s += self.staging_s - staged0
        return out

    def barrier(self) -> None:
        dist.barrier()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def _has_model_group(comm) -> bool:
    return comm is not None and comm.model_group is not None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; the gradient summed over the
    model group backward."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.model_all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, comm) -> torch.Tensor:
    """f at a column-parallel product's input (or on a replicated leaf
    that each model rank uses a part of): whole and equal gradients on
    every rank of the model group."""
    return _CopyToModel.apply(x, comm) if _has_model_group(comm) else x


def reduce_from_model(x: torch.Tensor, comm) -> torch.Tensor:
    """g at a row-parallel product's output: the partial sums summed."""
    return _ReduceFromModel.apply(x, comm) if _has_model_group(comm) else x


class _GatherFromModel(torch.autograd.Function):
    """The whole tensor from every model rank's block along ``dim``
    forward; the rank's own block of the gradient backward, summed with
    nothing (the gradient is whole on every rank, see
    :func:`gather_from_model`)."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return torch.cat(comm.model_gather(x.contiguous()), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.comm.model_index * ctx.n,
                           ctx.n), None, None


def gather_from_model(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    """A leaf sharded along ``dim`` gathered whole over the model group,
    for a use that every rank makes whole on the same inputs (a layer's
    shared expert whose layer dim the rules shard): its gradient is then
    whole and equal on every rank, and each keeps its block of it, where a
    reduce-scatter would scale it by the model size."""
    return (_GatherFromModel.apply(x, comm, dim) if _has_model_group(comm)
            else x)
