"""Carry parameters and fleet state between the JAX reference and the port.

Both packages keep the same names and layouts (conv weights HWIO, dense
weights (in, out)), so a conversion is a plain copy through numpy.  The
flat order of a parameter dict is its sorted key order — the JAX pytree
leaf order — so a flat vector means the same in both packages.  Leading
batch dimensions (the K clients of a round) ride in front of each leaf.

A nested tree (the LM's ``{"blocks": {"attn": {"wq": ...}}, ...}``, or a
hybrid's ``{"blocks": [{...}, {...}, ...]}``) is keyed by its leaves'
paths joined with "/" (``tree_paths``; a list's child by its index).  JAX
orders a dict's children by sorted key, a list's by index, and empty dicts
hold no leaf, so its ``tree_leaves`` order is the paths' order compared
part by part, an index as a number (``leaf_order``): "blocks/2" before
"blocks/10", which a string sort would put after it.

**A dtype per leaf.**  The reference keeps some leaves in float32 beside
the model's dtype (norm scales and biases, the MoE router).  The port
lays parameters out as one contiguous buffer per dtype (:class:`Layout`),
each holding its leaves in leaf order, the buffers in the order their
dtype first appears in leaf order.  Flat parameters (``Flat``) are that
one tensor where every leaf has one dtype — today's flat (..., D) vector
itself — and the tuple of the buffers otherwise.  The wire vector of the
round stays one float32 (..., D) in leaf order (the reference's
``tree_leaves`` concatenation): ``Layout.runs`` maps the buffers onto it.

**A rank's blocks.**  Under tensor parallelism (``sharding.rules``) rank
(c, m) holds, of a leaf whose spec shards dim d over "model", the m-th of
``mesh["model"]`` equal contiguous blocks along d (``take_block``), and
replicated leaves whole; ``local_layout`` is the :class:`Layout` of those
blocks (the same leaves, order and dtypes), ``gather_leaf`` puts a leaf
back together from its blocks, and ``weights_to_rank`` carries the
reference's parameters to one rank's flat buffers.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.rules import Spec, model_dim

#: flat parameters: one tensor (..., D) where every leaf has one dtype,
#: else one (..., n_b) buffer per dtype in ``Layout.buffer_dtypes`` order
Flat = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


def _leaf_key(path: str):
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p)
                 for p in path.split("/"))


def leaf_order(paths) -> list:
    """``paths`` in the reference's ``tree_leaves`` order: part by part,
    a list index (all digits) by its number."""
    return sorted(paths, key=_leaf_key)


class Layout(Mapping):
    """Every leaf's shape (the mapping: path -> shape, in leaf order) and
    dtype (``dtypes``), and where each leaf lies: in buffer
    ``buffer_dtypes.index(dtype)`` after the earlier leaves of its dtype.
    ``runs`` lists (buffer, offset in it, offset in the (..., D) wire
    vector, length) for each maximal run of consecutive leaves of one
    dtype: a leaf-by-leaf copy between the two is one copy a run."""

    def __init__(self, shapes: Mapping[str, Tuple[int, ...]],
                 dtypes: Mapping[str, torch.dtype]):
        self._shapes = {k: tuple(shapes[k]) for k in leaf_order(shapes)}
        self.dtypes = {k: dtypes[k] for k in self._shapes}
        order = []
        for dt in self.dtypes.values():
            if dt not in order:
                order.append(dt)
        self.buffer_dtypes: Tuple[torch.dtype, ...] = tuple(order)
        sizes = [0] * len(order)
        runs = []
        wire = 0
        for k, s in self._shapes.items():
            b, n = order.index(self.dtypes[k]), math.prod(s)
            if runs and runs[-1][0] == b:
                runs[-1][3] += n
            else:
                runs.append([b, sizes[b], wire, n])
            sizes[b] += n
            wire += n
        self.buffer_sizes: Tuple[int, ...] = tuple(sizes)
        self.runs: Tuple[Tuple[int, int, int, int], ...] = tuple(
            tuple(r) for r in runs)
        self.numel = wire

    @classmethod
    def uniform(cls, shapes: Mapping[str, Tuple[int, ...]],
                dtype: torch.dtype) -> "Layout":
        return cls(shapes, {k: dtype for k in shapes})

    def __getitem__(self, path: str) -> Tuple[int, ...]:
        return self._shapes[path]

    def __iter__(self) -> Iterator[str]:
        return iter(self._shapes)

    def __len__(self) -> int:
        return len(self._shapes)

    def __repr__(self) -> str:
        bufs = ", ".join(f"{str(dt)[6:]} {n:,}" for dt, n in
                         zip(self.buffer_dtypes, self.buffer_sizes))
        return f"Layout({len(self)} leaves, D={self.numel:,}: {bufs})"

    def buffer_of(self, path: str) -> int:
        return self.buffer_dtypes.index(self.dtypes[path])

    def empty(self, *, device: DeviceLike = None) -> Flat:
        """Uninitialized flat (D,) parameters."""
        dev = resolve_device(device)
        return pack(tuple(torch.empty((n,), dtype=dt, device=dev)
                          for dt, n in zip(self.buffer_dtypes,
                                           self.buffer_sizes)))

    def check(self, flat: Flat, device: torch.device = None) -> None:
        """Raise ValueError unless ``flat`` is this layout's flat (D,)
        parameters (on ``device``'s type, where given)."""
        bufs = buffers(flat)
        want = [((n,), dt) for dt, n in zip(self.buffer_dtypes,
                                            self.buffer_sizes)]
        got = [(tuple(b.shape), b.dtype) for b in bufs]
        on = device is None or all(b.device.type == device.type for b in bufs)
        if got != want or not on:
            where = f" on {device}" if device is not None else ""
            raise ValueError(
                "params must be " + ", ".join(
                    f"{s} {str(dt)[6:]}" for s, dt in want) + where +
                ", got " + ", ".join(f"{s} {str(dt)[6:]} on {b.device}"
                                     for (s, dt), b in zip(got, bufs)))


def buffers(flat: Flat) -> Tuple[torch.Tensor, ...]:
    """The flat parameters' buffers: (flat,) for one tensor."""
    return (flat,) if isinstance(flat, torch.Tensor) else tuple(flat)


def pack(bufs) -> Flat:
    """Buffers back to flat parameters: the one tensor where there is one."""
    bufs = tuple(bufs)
    return bufs[0] if len(bufs) == 1 else bufs


def map_buffers(fn: Callable[[torch.Tensor], torch.Tensor], flat: Flat) -> Flat:
    """``fn`` on every buffer (a clone, a move), packed as ``flat`` is."""
    return pack(fn(b) for b in buffers(flat))


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in d.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def param_shapes(params: Mapping[str, torch.Tensor],
                 batch_dims: int = 0) -> Layout:
    """The :class:`Layout` of ``params``: each leaf's shape without the
    leading batch dims, and its dtype."""
    return Layout({k: v.shape[batch_dims:] for k, v in params.items()},
                  {k: v.dtype for k, v in params.items()})


def flatten_params(params: Mapping[str, torch.Tensor],
                   batch_dims: int = 0) -> Flat:
    """Concatenate the leaves in leaf order: (*batch, D) where every leaf
    has one dtype, else one (*batch, n_b) buffer per dtype in the order
    the dtypes first appear (:class:`Layout`)."""
    leaves = [params[k] for k in leaf_order(params)]
    batch = leaves[0].shape[:batch_dims]
    order = []
    for v in leaves:
        if v.dtype not in order:
            order.append(v.dtype)
    return pack(torch.cat([v.reshape(*batch, -1) for v in leaves
                           if v.dtype == dt], dim=-1) for dt in order)


def unflatten_params(flat: Flat, layout: Layout) -> Dict[str, torch.Tensor]:
    """Views of ``flat``'s buffers (*batch, n_b) with each leaf's shape
    behind the batch dims, in ``layout``'s leaf order."""
    bufs = buffers(flat)
    nbuf = len(layout.buffer_dtypes)
    if len(bufs) != nbuf:
        raise ValueError(f"{len(bufs)} flat buffers for a layout of {nbuf}")
    batch = bufs[0].shape[:-1]
    out, offs = {}, [0] * nbuf
    for k, shape in layout.items():
        b = layout.buffer_of(k)
        n = math.prod(shape)
        out[k] = bufs[b][..., offs[b]:offs[b] + n].reshape(*batch, *shape)
        offs[b] += n
    for b, off in zip(bufs, offs):
        if off != b.shape[-1]:
            raise ValueError(f"flat width {b.shape[-1]} != {off} parameters")
    return out


def local_layout(layout: Layout, specs: Mapping[str, Spec],
                 mesh: Mapping[str, int]) -> Layout:
    """The :class:`Layout` of one rank's blocks: each leaf's dim sharded
    over "model" divided by ``mesh["model"]`` (the same for every rank)."""
    n = mesh.get("model", 1)
    shapes = {}
    for path, shape in layout.items():
        d, shape = model_dim(specs[path]), list(shape)
        if d is not None:
            if shape[d] % n:
                raise ValueError(f"{path}: dim {d} of {tuple(shape)} does "
                                 f"not split over model={n}")
            shape[d] //= n
        shapes[path] = tuple(shape)
    return Layout(shapes, layout.dtypes)


def take_block(x: torch.Tensor, spec: Spec, mesh: Mapping[str, int],
               coords: Mapping[str, int]) -> torch.Tensor:
    """The block of the whole leaf ``x`` that the rank at ``coords`` holds:
    the ``coords["model"]``-th of ``mesh["model"]`` along the dim ``spec``
    shards over "model" (a view), or ``x`` itself.  Leading batch dims of
    ``x`` beyond ``len(spec)`` are kept."""
    d = model_dim(spec)
    if d is None:
        return x
    d += x.dim() - len(spec)
    n = x.shape[d] // mesh["model"]
    return x.narrow(d, coords["model"] * n, n)


def gather_leaf(blocks, spec: Spec) -> torch.Tensor:
    """The whole leaf from every model rank's block, in model order (a
    replicated leaf: the first)."""
    d = model_dim(spec)
    if d is None:
        return blocks[0]
    return torch.cat(list(blocks), dim=d + blocks[0].dim() - len(spec))


def weights_to_rank(tree: Mapping, specs: Mapping[str, Spec],
                    mesh: Mapping[str, int], rank: int,
                    dtype: Optional[torch.dtype] = torch.float32,
                    device: DeviceLike = None) -> Flat:
    """The reference's parameters (a nested dict of numpy leaves) as the
    flat buffers of rank ``rank``'s blocks (row-major mesh coordinates),
    in leaf order; ``dtype`` as :func:`flat_from_tree`'s."""
    from repro_torch.core.comm import coords as rank_coords

    at = rank_coords(mesh, rank)
    dev = resolve_device(device)
    leaves = {}
    for k, v in tree_paths(tree).items():
        a = np.asarray(v)
        t = torch.from_numpy(np.array(a, np.float32))
        t = take_block(t, specs[k], mesh, at).contiguous()
        leaves[k] = t.to(dtype if dtype is not None else _torch_dtype(a))
    return map_buffers(lambda b: b.to(dev), flatten_params(leaves))


def tree_paths(tree: Union[Mapping, list, tuple],
               prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested tree's leaves keyed by their "/"-joined paths, a list's or
    tuple's child by its index; an empty dict (a non-parametric norm's)
    has no leaf."""
    out: Dict[str, np.ndarray] = {}
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (Mapping, list, tuple)):
            out.update(tree_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


def flat_from_tree(tree: Mapping, dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> Flat:
    """A nested dict of numpy leaves (the reference's parameters through
    ``np.asarray``) -> the port's flat parameters in leaf order: with
    ``dtype=None`` each leaf keeps its own dtype (a buffer per dtype,
    :func:`flatten_params`), else every leaf is cast to ``dtype`` (one
    (D,) vector).  A bfloat16 leaf (``ml_dtypes.bfloat16``) passes through
    float32, which holds it exactly."""
    dev = resolve_device(device)
    leaves = {}
    for k, v in tree_paths(tree).items():
        a = np.asarray(v)
        t = torch.from_numpy(np.array(a, np.float32).reshape(-1))
        leaves[k] = t.to(dtype if dtype is not None else _torch_dtype(a))
    return map_buffers(lambda b: b.to(dev), flatten_params(leaves))


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
    """The reference's decode cache through ``np.asarray`` -> the port's
    (``models.transformer``, ``models.whisper``).  A dense LM's
    ``{"layers": (k, v), "kv_pos", "length"}`` -> ``{"k", "v", "kv_pos",
    "length"}``, k and v (L, B, C, KV, hd); an MLA stack's ``{"layers":
    latent, ...}`` -> ``{"latent", ...}``, the latent (L, B, C, r +
    d_rope); whisper's ``{"k", "v", "cross_k", "cross_v", "kv_pos",
    "length"}`` keeps its keys; RWKV-6's ``{"layers": {"S", "x_tm",
    "x_cm"}, "length"}`` ->
    ``{"S", "x_tm", "x_cm", "length"}``; the hybrid's list of per-layer
    entries (``{"h", "conv"}`` or (k, v)) -> h and conv stacked over the
    recurrent layers, k and v over the attention layers, in layer order.
    The states S and h float32, every other float entry in ``dtype`` (a
    bfloat16 leaf passes through float32, which holds it exactly), kv_pos
    (B, C) and the 0-d length int32."""
    dev = resolve_device(device)

    def tensor(arrays, dt):
        a = np.stack([np.asarray(x, np.float32) for x in arrays])
        return torch.from_numpy(a).to(dev, dt)

    out = {}
    layers = cache.get("layers")
    if layers is None:                              # whisper's
        for name in ("k", "v", "cross_k", "cross_v"):
            out[name] = tensor([cache[name]], dtype)[0]
    elif hasattr(layers, "ndim"):                   # the MLA latent
        out["latent"] = tensor([layers], dtype)[0]
    elif isinstance(layers, Mapping):               # RWKV-6, layer-stacked
        out["S"] = tensor([layers["S"]], torch.float32)[0]
        out["x_tm"] = tensor([layers["x_tm"]], dtype)[0]
        out["x_cm"] = tensor([layers["x_cm"]], dtype)[0]
    elif isinstance(layers, list):                  # the hybrid's layers
        rec = [e for e in layers if isinstance(e, Mapping)]
        att = [e for e in layers if not isinstance(e, Mapping)]
        if rec:
            out["h"] = tensor([e["h"] for e in rec], torch.float32)
            out["conv"] = tensor([e["conv"] for e in rec], dtype)
        if att:
            out["k"] = tensor([e[0] for e in att], dtype)
            out["v"] = tensor([e[1] for e in att], dtype)
    else:                                           # (k, v), layer-stacked
        out["k"] = tensor([layers[0]], dtype)[0]
        out["v"] = tensor([layers[1]], dtype)[0]
    for name in ("kv_pos", "length"):
        if cache.get(name) is not None:
            out[name] = torch.tensor(np.asarray(cache[name], np.int32),
                                     device=dev)
    return out


def cache_to_reference(cache: Mapping[str, torch.Tensor],
                       kinds: Optional[Tuple[str, ...]] = None) -> Dict:
    """The port's cache -> the reference's layout of numpy arrays, every
    float entry as float32 (cast to the reference's dtype on its side),
    kv_pos and length int32: an MLA stack's latent as its "layers",
    whisper's entries under their own keys.  ``kinds``, the hybrid's
    block kinds in layer
    order (``LM.kinds``), lays its states and k/v out as the reference's
    list of layers (its kv_pos None without an attention layer); without
    it the cache is a stack's."""
    def arr(t):
        return t.detach().float().cpu().numpy()

    out = {"length": cache["length"].cpu().numpy().astype(np.int32)}
    if "kv_pos" in cache or kinds is not None:
        out["kv_pos"] = (cache["kv_pos"].cpu().numpy().astype(np.int32)
                         if "kv_pos" in cache else None)
    if "cross_k" in cache:                          # whisper's
        out.update({n: arr(cache[n])
                    for n in ("k", "v", "cross_k", "cross_v")})
    elif "latent" in cache:
        out["layers"] = arr(cache["latent"])
    elif "S" in cache:
        out["layers"] = {n: arr(cache[n]) for n in ("S", "x_tm", "x_cm")}
    elif kinds is None:
        out["layers"] = (arr(cache["k"]), arr(cache["v"]))
    else:
        layers, r, a = [], 0, 0
        for kind in kinds:
            if kind == "recurrent":
                layers.append({"h": arr(cache["h"][r]),
                               "conv": arr(cache["conv"][r])})
                r += 1
            else:
                layers.append((arr(cache["k"][a]), arr(cache["v"][a])))
                a += 1
        out["layers"] = layers
    return out
