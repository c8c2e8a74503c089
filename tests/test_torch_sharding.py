"""The port's placement rules (``repro_torch.sharding``) and input
partition specs (``repro_torch.launch.inputs``) against the reference's
``repro.sharding`` and ``repro.launch.inputs``, exactly.

The reference reads a mesh's ``shape``; a namespace with that dict stands
in for a ``Mesh`` (as ``tests/test_launch.py`` does), and its
``launch.inputs._ns`` is swapped for ``PartitionSpec`` itself, so that
its specs need no device.  A reference spec is padded with None to its
leaf's rank (``P()`` is "whole" at any rank); a port spec has one entry
per dim.  Cases: every config of the zoo, full and reduced, on the
meshes (2, 4), (1, 4), (1, 3), (16, 16) and (2, 16, 16), under the
default flags and under ``fsdp``, ``dp_over_model`` and
``zero_over_model``; ``bytes_per_device`` on the same; the three input
spec functions on every input shape (and the batch-6 ``decode_32k`` of
``tests/test_launch.py``'s seq-over-model fallback) with and without
``decode_batch_2d``.
"""
import dataclasses
import functools
import math
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.config.base import apply_overrides as japply
from repro.configs import shapes as jshapes
from repro.launch import inputs as jinputs
from repro.models import build_model as jbuild
from repro.sharding import context as jcontext
from repro.sharding import rules as jrules
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.config import apply_overrides as tapply
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.sharding import context as tcontext
from repro_torch.sharding import rules as trules

ARCHS = tuple(tconfigs.list_archs())
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = {"default": (), "fsdp": ("train.fsdp=true",),
         "dp_over_model": ("train.dp_over_model=true",),
         "zero_over_model": ("train.zero_over_model=true",)}


def _fake(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _pad(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _configs(arch, size, flags):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if size == "reduced":
        j, t = jconfigs.reduced(j), tconfigs.reduced(t)
    return japply(j, FLAGS[flags]), tapply(t, FLAGS[flags])


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, size):
    """The reference's leaves as {path: (shape, itemsize)} (eval_shape of
    its init: nothing allocated), and its abstract tree."""
    j, _ = _configs(arch, size, "default")
    tree = jax.eval_shape(jbuild(j).init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return tree, {"/".join(jrules._path_names(p)): (tuple(a.shape),
                                                    a.dtype.itemsize)
                  for p, a in leaves}


def _ref_specs(arch, size, flags, mesh):
    j, _ = _configs(arch, size, flags)
    tree, _ = _ref_shapes(arch, size)
    rules = jrules.ParamRules(j, _fake(mesh))
    specs = jax.tree_util.tree_map_with_path(rules.spec_for, tree)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(jrules._path_names(p)): s for p, s in flat}


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_bytes_equal_the_references(arch, size):
    """Leaf for leaf, every mesh and flag; ``bytes_per_device`` too (the
    reference's over stand-in shardings with that mesh)."""
    _, shapes = _ref_shapes(arch, size)
    sharded = 0
    for flags in FLAGS:
        _, t = _configs(arch, size, flags)
        model = tbuild(t)
        layout = model.param_shapes
        assert list(layout) == list(shapes), arch
        for path in layout:
            assert (tuple(layout[path]), layout.dtypes[path].itemsize) \
                == shapes[path], path
        tree, _ = _ref_shapes(arch, size)
        for mesh in MESHES:
            want = _ref_specs(arch, size, flags, mesh)
            got = trules.param_specs(model, t, _fake(mesh).shape)
            for path, spec in got.items():
                assert len(spec) == len(layout[path]), (path, spec)
                assert spec == _pad(want[path], len(spec)), \
                    (arch, size, flags, mesh, path, spec, want[path])
                sharded += trules.model_dim(spec) is not None
            shardings = jax.tree_util.tree_map(
                lambda s: types.SimpleNamespace(spec=s, mesh=_fake(mesh)),
                [want[p] for p in layout],
                is_leaf=lambda x: isinstance(x, P))
            leaves = jax.tree_util.tree_leaves(tree)
            want_bytes = jrules.bytes_per_device(leaves, shardings)
            assert trules.bytes_per_device(
                layout, got, _fake(mesh).shape) == want_bytes, \
                (arch, size, flags, mesh)
            # a rank's blocks: the reference's bytes, but under train.fsdp,
            # whose "data" entries the port stores whole
            local = convert.local_layout(layout, got, _fake(mesh).shape)
            held = sum(math.prod(local[k]) * local.dtypes[k].itemsize
                       for k in local)
            if t.train.fsdp:
                assert held >= want_bytes
            else:
                assert held == want_bytes, (arch, size, flags, mesh)
    if arch == "mnist_cnn":
        # the QNN's leaves match no rule: the reference shards none
        assert sharded == 0


def test_model_dim_and_the_tensor_parallel_leaves():
    """The rules the tensor-parallel forward reads: reduced qwen2.5-14b
    with 2 kv heads shards wq/wo and replicates wk/wv at model 4, and
    replicates all of attention at model 3."""
    cfg = tapply(tconfigs.reduced(tconfigs.get_config("qwen2.5-14b")),
                 ("model.n_kv_heads=2",))
    model = tbuild(cfg)
    at4 = trules.param_specs(model, cfg, make_mesh((1, 4), ("data", "model")))
    assert at4["blocks/attn/wq"] == (None, None, "model")
    assert at4["blocks/attn/wo"] == (None, "model", None)
    assert at4["blocks/attn/wk"] == (None, None, None)
    assert at4["blocks/attn/bq"] == (None, None)
    assert at4["embed"] == ("model", None) and at4["head"] == (None, "model")
    assert trules.model_dim(at4["blocks/mlp/w_down"]) == 1
    at3 = trules.param_specs(model, cfg, make_mesh((1, 3), ("data", "model")))
    assert all(trules.model_dim(s) is None for s in at3.values())


def test_resolve_logical_equals_the_references():
    for mesh in MESHES:
        fake = _fake(mesh)
        for logical in list(tcontext.DEFAULT_RULES) + [None, "nope"]:
            for n in (1, 3, 4, 12, 16, 50_304, 151_936, 512):
                got = tcontext.resolve_logical(fake.shape, logical, n)
                assert got == jcontext.resolve_logical(fake, logical, n)
    over = {"batch": (("pod", "data", "model"),)}
    mesh = make_mesh((2, 4), ("data", "model"))
    with tcontext.use_sharding_rules(mesh, over):
        assert tcontext.current_mesh() == mesh
        assert tcontext.current_rules()["batch"] == over["batch"]
        assert tcontext.resolve_logical(mesh, "batch", 8) == ("data", "model")
    assert tcontext.current_mesh() is None
    assert tcontext.current_rules() == tcontext.DEFAULT_RULES


SHAPE_CASES = [(s, None) for s in tshapes.SHAPES] + [("decode_32k", 6)]


def _shape(mod, name, batch):
    shape = mod.get_shape(name)
    return dataclasses.replace(shape, global_batch=batch) if batch else shape


def _dtype_name(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.fixture
def ref_ns(monkeypatch):
    """The reference's ``_ns`` without a device mesh: the spec itself."""
    monkeypatch.setattr(jinputs, "_ns", lambda mesh, *entries: P(*entries))


def _cache_pairs(ref_cache, port):
    """(reference leaf path, port name, whether the port stacks it over a
    leading layer dim the reference's list does not have)."""
    flat = jax.tree_util.tree_flatten_with_path(
        ref_cache, is_leaf=lambda x: isinstance(x, P))[0]
    out = []
    for path, leaf in flat:
        names = [str(getattr(p, "key", getattr(p, "idx", ""))) for p in path]
        if names[0] != "layers":
            out.append((path, leaf, names[0], False))
        elif "latent" in port:
            out.append((path, leaf, "latent", False))
        elif len(names) == 2 and names[1] in ("0", "1"):
            out.append((path, leaf, "kv"[int(names[1])], False))
        elif len(names) == 2:
            out.append((path, leaf, names[1], False))
        else:                                   # the hybrid's list
            name = names[2] if names[2] in ("h", "conv") else "kv"[int(names[2])]
            out.append((path, leaf, name, True))
    return out


@pytest.mark.parametrize("batch_2d", [False, True])
@pytest.mark.parametrize("shape_name, batch", SHAPE_CASES)
def test_input_specs_equal_the_references(ref_ns, shape_name, batch,
                                          batch_2d):
    flags = ("train.decode_batch_2d=true",) if batch_2d else ()
    for arch in ARCHS:
        jcfg = japply(jconfigs.get_config(arch), flags)
        tcfg = tapply(tconfigs.get_config(arch), flags)
        if batch_2d:
            jcfg = japply(jcfg, ("train.dp_over_model=true",))
            tcfg = tapply(tcfg, ("train.dp_over_model=true",))
        jshape, tshape = (_shape(jshapes, shape_name, batch),
                          _shape(tshapes, shape_name, batch))
        supported = jconfigs.supports_shape(jcfg, jshape)
        assert tconfigs.supports_shape(tcfg, tshape) == supported
        if not supported:
            continue
        jm, tm = (jconfigs.for_shape(jcfg, jshape),
                  tconfigs.for_shape(tcfg, tshape))
        jmodel = None if arch == "mnist_cnn" else jbuild(jm)
        tmodel = None if arch == "mnist_cnn" else tbuild(tm)
        for mesh in MESHES:
            fake = _fake(mesh)
            assert tinputs.dp_axes(fake.shape) == jinputs.dp_axes(fake)
            (js, jsh), (ts, tsh) = (jinputs.train_batch_specs(jm, jshape, fake),
                                    tinputs.train_batch_specs(tm, tshape,
                                                              fake.shape))
            assert list(ts) == list(js)
            for k in js:
                assert tuple(ts[k].shape) == js[k].shape
                assert ts[k].device.type == "meta"
                assert _dtype_name(ts[k]) == str(js[k].dtype)
                assert tsh[k] == _pad(jsh[k], ts[k].dim()), (arch, mesh, k)
            if jmodel is None:
                continue
            (js, jsh), (ts, tsh) = (jinputs.prefill_specs(jm, jshape, fake),
                                    tinputs.prefill_specs(tm, tshape,
                                                          fake.shape))
            assert [tuple(t.shape) for t in ts] == [j.shape for j in js]
            assert [_dtype_name(t) for t in ts] == [str(j.dtype) for j in js]
            assert tsh == tuple(_pad(s, t.dim()) for s, t in zip(jsh, ts))
            (jc, jt), (jcs, jts) = jinputs.decode_specs(jmodel, jm, jshape,
                                                        fake)
            (tc, tt), (tcs, tts) = tinputs.decode_specs(tmodel, tm, tshape,
                                                        fake.shape)
            assert tuple(tt.shape) == jt.shape and tts == _pad(jts, 2)
            pairs = _cache_pairs(jcs, tc)
            leaves = dict((tuple(p), l) for p, l in
                          jax.tree_util.tree_flatten_with_path(jc)[0])
            assert {name for *_, name, _ in pairs} == set(tc), (arch, list(tc))
            for path, jspec, name, stacked in pairs:
                t = tc[name]
                assert t.device.type == "meta"
                shape = tuple(t.shape[1:] if stacked else t.shape)
                ref = leaves[tuple(path)]
                assert shape == tuple(ref.shape), (arch, name)
                spec = tcs[name][1:] if stacked else tcs[name]
                assert spec == _pad(jspec, len(shape)), \
                    (arch, shape_name, batch, mesh, name, spec, jspec)
                if stacked:
                    assert tcs[name][0] is None
