"""Checkpoints in the reference's msgpack layout, written and read by the
port's own codec (``repro.checkpoint.ckpt`` is the reference).

One file ``ckpt_{step}.msgpack`` a step: a msgpack array with one map a
leaf, in the reference's leaf order (a mapping's children by sorted key, a
NamedTuple's by field, a list's in order; ``None`` holds no leaf):

  an ordinary leaf  {b"__nd__": True, b"data": <bytes>,
                     b"dtype": arr.dtype.str, b"shape": [dims]}
  a bfloat16 leaf   {b"__bf16__": True, b"data": <uint16 bytes>,
                     b"shape": [dims]}

Keys are bin, strings str and ints the smallest msgpack form, as
``msgpack.packb(..., use_bin_type=True)`` writes them, so each package
reads the other's files (the tests hold the bytes equal).  The codec covers
that subset only.  It writes leaf by leaf to the file (a ``.tmp`` then
``os.replace``), never the whole payload in memory, and reads the file
once into one buffer that every leaf views (``np.frombuffer``).
Retention keeps the ``keep`` newest steps.

The port's flat parameters travel as the reference's tree of leaves, each
in its dtype: :func:`save_params` writes the leaves of
``convert.unflatten_params(flat, layout)`` in the layout's leaf order (a
hybrid's "blocks/2" before "blocks/10"), :func:`restore_params` reads them
back into the flat layout (a buffer per dtype where the leaves have more
than one).
"""
from __future__ import annotations

import os
import re
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert

_STEP_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")
_CHUNK = 1 << 30    # bytes a read() call fills: Linux caps one read near 2 GiB

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative size {n}")
    if n < 0x80:
        return bytes((n,))
    if n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    return b"\xcf" + struct.pack(">Q", n)


def _sized(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
           widths: Tuple[str, ...]) -> bytes:
    if fix >= 0 and n < fix_max:
        return bytes((fix | n,))
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"{n} is too long for msgpack")


def _bin_header(n: int) -> bytes:
    return _sized(n, -1, 0, (0xC4, 0xC5, 0xC6), (">B", ">H", ">I"))


def _bin(b: bytes) -> bytes:
    return _bin_header(len(b)) + b


def _str(s: str) -> bytes:
    b = s.encode()
    return _sized(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB),
                  (">B", ">H", ">I")) + b


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, (0xDC, 0xDD), (">H", ">I"))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, (0xDE, 0xDF), (">H", ">I"))


_TRUE = b"\xc3"


class _Reader:
    """A cursor over the file's bytes that decodes the subset above; bin
    values come back as (offset, length) into the buffer."""

    def __init__(self, buf: bytearray):
        self.buf = buf
        self.mv = memoryview(buf)
        self.pos = 0

    def _take(self, fmt: str) -> int:
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def value(self) -> Any:
        c = self.buf[self.pos]
        self.pos += 1
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._text(c & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in fixed:
            return fixed[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self._take(ints[c])
        if c in (0xC4, 0xC5, 0xC6):
            n = self._take({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])
            self.pos += n
            return (self.pos - n, n)
        if c in (0xD9, 0xDA, 0xDB):
            return self._text(self._take({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[c]))
        if c in (0xDC, 0xDD):
            n = self._take(">H" if c == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self._map(self._take(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type 0x{c:02x} at byte {self.pos - 1} is "
                         "outside the checkpoint format")

    def _text(self, n: int) -> str:
        self.pos += n
        return bytes(self.mv[self.pos - n:self.pos]).decode()

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            if isinstance(k, tuple):           # a bin key
                k = bytes(self.mv[k[0]:k[0] + k[1]])
            out[k] = self.value()
        return out


# ---------------------------------------------------------------------------
# leaves and trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the reference's order (``jax.tree_util.tree_leaves``
    for dicts, NamedTuples, lists and tuples of arrays)."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in tree_leaves(child)]
    return [tree]


def _unflatten(template: Any, leaves: List[Any], at: List[int]) -> Any:
    if template is None:
        return None
    if isinstance(template, Mapping):
        got = {k: _unflatten(template[k], leaves, at) for k in sorted(template)}
        return {k: got[k] for k in template}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(c, leaves, at) for c in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(c, leaves, at) for c in template)
    leaf = leaves[at[0]]
    at[0] += 1
    return _as_template(leaf, template)


def _as_template(arr: np.ndarray | torch.Tensor, template: Any) -> Any:
    """A restored leaf (a numpy view of the file, or a bfloat16 tensor) in
    the template's kind: a tensor on the template's device, else numpy."""
    if not isinstance(template, torch.Tensor):
        return arr.float().numpy() if isinstance(arr, torch.Tensor) else arr.copy()
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
    if template.device.type == "cpu":
        return t.clone()
    return t.to(template.device)


def _leaf_bytes(leaf: Any) -> Tuple[bool, Optional[str], List[int], np.ndarray]:
    """(bfloat16, dtype str, shape, the bytes as a flat uint8 array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).cpu().numpy()
            return True, None, list(t.shape), arr.reshape(-1).view(np.uint8)
        arr = t.cpu().numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
        if arr.dtype.name == "bfloat16":
            return (True, None, list(arr.shape),
                    arr.view(np.uint16).reshape(-1).view(np.uint8))
    return (False, arr.dtype.str, [int(d) for d in arr.shape],
            arr.reshape(-1).view(np.uint8))


def _write_leaf(f, leaf: Any) -> None:
    bf16, dtype, shape, data = _leaf_bytes(leaf)
    shape_b = _array_header(len(shape)) + b"".join(_uint(d) for d in shape)
    if bf16:
        f.write(_map_header(3) + _bin(b"__bf16__") + _TRUE + _bin(b"data")
                + _bin_header(data.nbytes))
        f.write(data)
        f.write(_bin(b"shape") + shape_b)
    else:
        f.write(_map_header(4) + _bin(b"__nd__") + _TRUE + _bin(b"data")
                + _bin_header(data.nbytes))
        f.write(data)
        f.write(_bin(b"dtype") + _str(dtype) + _bin(b"shape") + shape_b)


def _decode(r: _Reader, obj: Any) -> Any:
    if isinstance(obj, dict) and b"__bf16__" in obj:
        off, n = obj[b"data"]
        arr = np.frombuffer(r.buf, np.int16, n // 2, off)
        return torch.from_numpy(arr.reshape(obj[b"shape"])).view(torch.bfloat16)
    if isinstance(obj, dict) and b"__nd__" in obj:
        off, n = obj[b"data"]
        dtype = np.dtype(obj[b"dtype"])
        return np.frombuffer(r.buf, dtype, n // dtype.itemsize,
                             off).reshape(obj[b"shape"])
    raise ValueError(f"checkpoint entry {obj!r} is not an array leaf")


def _read(path: str) -> List[Any]:
    size = os.path.getsize(path)
    buf = bytearray(size)
    mv = memoryview(buf)
    with open(path, "rb", buffering=0) as f:
        pos = 0
        while pos < size:
            n = f.readinto(mv[pos:pos + _CHUNK])
            if not n:
                raise ValueError(f"{path}: short read at byte {pos} of {size}")
            pos += n
    r = _Reader(buf)
    raw = r.value()
    if not isinstance(raw, list) or r.pos != size:
        raise ValueError(f"{path} is not one msgpack array of leaves")
    return [_decode(r, o) for o in raw]


# ---------------------------------------------------------------------------
# the reference's API
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, tree: Any, *,
                    keep: int = 3) -> str:
    """Write ``tree``'s leaves to ``directory/ckpt_{step}.msgpack`` and keep
    the ``keep`` newest steps; returns the path."""
    os.makedirs(directory, exist_ok=True)
    leaves = tree_leaves(tree)
    path = os.path.join(directory, f"ckpt_{step}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_array_header(len(leaves)))
        for leaf in leaves:
            _write_leaf(f, leaf)
    os.replace(tmp, path)
    for s in sorted(_all_steps(directory))[:-keep]:
        os.remove(os.path.join(directory, f"ckpt_{s}.msgpack"))
    return path


def _all_steps(directory: str) -> List[int]:
    return [int(m.group(1)) for m in map(_STEP_RE.match, os.listdir(directory))
            if m]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _all_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """The checkpoint of ``step`` (default the latest) in ``template``'s
    structure: a tensor leaf comes back as a tensor on the template leaf's
    device in the file's dtype, any other leaf as a numpy array.  Raises
    ValueError where the file's leaf count or a leaf's shape is not the
    template's (the reference's ``tree_unflatten`` raises on the count)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    leaves = _read(os.path.join(directory, f"ckpt_{step}.msgpack"))
    want = tree_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(f"checkpoint step {step} holds {len(leaves)} leaves, "
                         f"the template {len(want)}")
    for i, (got, ref) in enumerate(zip(leaves, want)):
        shape = tuple(np.shape(ref))
        if tuple(got.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(got.shape)}, "
                             f"template {shape}")
    return _unflatten(template, leaves, [0])


def save_params(directory: str, step: int, flat: convert.Flat,
                layout: convert.Layout, *, keep: int = 3) -> str:
    """Save the flat (D,) parameters as the reference's tree of leaves,
    each leaf in its dtype (``layout`` the model's ``param_shapes``)."""
    leaves = convert.unflatten_params(flat, layout)
    return save_checkpoint(directory, step, list(leaves.values()), keep=keep)


def restore_params(directory: str, flat: convert.Flat, layout: convert.Layout,
                   step: Optional[int] = None) -> convert.Flat:
    """A parameter checkpoint as new flat parameters in ``flat``'s layout
    on its device: the leaves restored against ``flat``'s, concatenated in
    leaf order, a buffer per dtype.  A leaf of another dtype than its
    template's raises ValueError."""
    bufs = convert.buffers(flat)
    if any(b.dim() != 1 for b in bufs):
        raise ValueError("flat must be (D,) (a buffer per dtype), got "
                         f"{[tuple(b.shape) for b in bufs]}")
    template = convert.unflatten_params(flat, layout)
    leaves = dict(zip(template, restore_checkpoint(
        directory, list(template.values()), step)))
    bad = {k: v.dtype for k, v in leaves.items()
           if v.dtype != template[k].dtype}
    if bad:
        want = sorted({str(template[k].dtype) for k in bad})
        raise ValueError(f"checkpoint leaves {bad} are not the parameters' "
                         f"{', '.join(want)}")
    return convert.flatten_params(leaves)
