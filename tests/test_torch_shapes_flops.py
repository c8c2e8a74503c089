"""The port's input shapes, shape registry and analytic cost model
(``repro_torch.configs.shapes``, ``configs.for_shape`` and its kin,
``launch.inputs``, ``utils.flops``, ``utils.roofline``) against the
reference's ``repro.configs``, ``repro.launch.inputs`` and ``repro.utils``.

``analytic_costs`` is the same arithmetic on the same config, so every
field is held equal exactly: olmo-1b and its reduced form, every shape,
the meshes (1, 1), (2, 4) and (2, 16, 16), and the step kinds as the
reference's dry run spells them (``prefill``, ``decode``,
``train/standard``, ``train/fl_round`` in every collective mode).  The
reference reads a mesh's ``shape``, the port takes its dict of sizes.
"""
import dataclasses
import types

import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.launch import inputs as jinputs
from repro.models import build_model as jbuild_model
from repro.utils import compat as jcompat
from repro.utils import flops as jflops
from repro.utils import roofline as jroofline
from repro_torch import configs as tconfigs
from repro_torch.config.base import COLLECTIVE_CHOICES
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import inputs as tinputs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.utils import flops as tflops
from repro_torch.utils import roofline as troofline

ARCHS = ("olmo-1b", "mnist_cnn", "qwen2.5-14b", "yi-9b",
         "nemotron-4-340b", "granite-moe-1b-a400m", "rwkv6-7b",
         "recurrentgemma-2b", "deepseek-v3-671b", "whisper-base",
         "chameleon-34b")
#: the last slice's configs: MLA with a shared expert and MTP, the
#: encoder-decoder and the vlm family
ZOO = ("deepseek-v3-671b", "whisper-base", "chameleon-34b")
MESHES = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _sections(cfg):
    return {k: dataclasses.asdict(getattr(cfg, k)) for k in ("model", "train")}


def test_shapes_match():
    assert ({k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()})
    for name in jshapes.SHAPES:
        assert tshapes.get_shape(name) == tshapes.SHAPES[name]
        assert tconfigs.get_shape(name) == tshapes.SHAPES[name]
    with pytest.raises(KeyError, match="unknown shape"):
        tshapes.get_shape("train_8k")
    assert set(tconfigs.list_archs()) == set(ARCHS)
    assert set(ARCHS) <= set(jconfigs.list_archs())
    assert tconfigs.LONG_CONTEXT_WINDOW == jconfigs.LONG_CONTEXT_WINDOW


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_shape_registry_matches(arch, shape):
    """``supports_shape``, ``is_subquadratic`` and ``for_shape`` as the
    reference's, for the full config and its reduced form; for_shape
    raises where the reference's does."""
    for reduce in (False, True):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        if reduce:
            j, t = jconfigs.reduced(j), tconfigs.reduced(t)
        js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
        assert tconfigs.supports_shape(t, ts) == jconfigs.supports_shape(j, js)
        assert tconfigs.is_subquadratic(t) == jconfigs.is_subquadratic(j)
        if not jconfigs.supports_shape(j, js):
            with pytest.raises(ValueError, match="does not support"):
                tconfigs.for_shape(t, ts)
            continue
        jf, tf = jconfigs.for_shape(j, js), tconfigs.for_shape(t, ts)
        assert _sections(tf) == _sections(jf)
        assert tconfigs.is_subquadratic(tf) == jconfigs.is_subquadratic(jf)
    if arch == "olmo-1b":
        window = tconfigs.for_shape(t, tshapes.SHAPES["long_500k"])
        assert window.model.attention_window == 8192
        assert tconfigs.is_subquadratic(window)


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_serving_batches_and_cache_match(shape):
    """``launch.inputs``: the (B, S) prompt and the (B, 1) token of each
    shape, int32, as the reference's structs; olmo-1b's cache at the
    shape (for_shape's window on long_500k) has the reference's leaves'
    shapes and dtypes (built on the meta device: nothing allocated)."""
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    jcfg = jconfigs.for_shape(jconfigs.get_config("olmo-1b"), js)
    tcfg = tconfigs.for_shape(tconfigs.get_config("olmo-1b"), ts)
    mesh = jcompat.make_mesh((1, 1), ("data", "model"))
    (tok,), _ = jinputs.prefill_specs(jcfg, js, mesh)
    assert tinputs.prefill_shape(ts) == tok.shape
    assert tinputs.TOKEN_DTYPE == torch.int32 and str(tok.dtype) == "int32"
    jmodel = jbuild_model(jcfg)
    (jcache, jtok), _ = jinputs.decode_specs(jmodel, jcfg, js, mesh)
    assert tinputs.decode_shape(ts) == jtok.shape
    tcache = build_model(tcfg).init_cache(js.global_batch, js.seq_len,
                                          device="meta")
    k, v = jcache["layers"]
    for name, want in (("k", k), ("v", v), ("kv_pos", jcache["kv_pos"]),
                       ("length", jcache["length"])):
        assert tuple(tcache[name].shape) == want.shape, name
        assert str(tcache[name].dtype).removeprefix("torch.") == str(want.dtype)
    gen = torch.Generator().manual_seed(0)
    drawn = tinputs.random_tokens((2, 5), 7, gen)
    assert drawn.dtype == torch.int32 and 0 <= int(drawn.min()) <= int(drawn.max()) < 7


def _step_kinds(kind):
    if kind == "train":
        return ([("train/standard", "paper")]
                + [("train/fl_round", m) for m in COLLECTIVE_CHOICES])
    return [(kind, "paper")]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
def test_analytic_costs_match_exactly(reduce, shape, mesh):
    """Every field of ``CostBreakdown`` equal, at the shape's config
    (``for_shape``), in every step kind and collective mode."""
    j, t = jconfigs.get_config("olmo-1b"), tconfigs.get_config("olmo-1b")
    if reduce:
        j, t = jconfigs.reduced(j), tconfigs.reduced(t)
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    j, t = jconfigs.for_shape(j, js), tconfigs.for_shape(t, ts)
    sizes, axes = mesh
    jmesh = types.SimpleNamespace(shape=dict(zip(axes, sizes)))
    tmesh = make_mesh(sizes, axes)
    for step_kind, mode in _step_kinds(js.kind):
        want = jflops.analytic_costs(j, js, jmesh, step_kind=step_kind,
                                     collective_mode=mode)
        got = tflops.analytic_costs(t, ts, tmesh, step_kind=step_kind,
                                    collective_mode=mode)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (
            step_kind, mode)
        assert (got.total_flops, got.total_bytes, got.total_collective) == (
            want.total_flops, want.total_bytes, want.total_collective)


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_roofline_terms_take_the_h100_constants(shape):
    """``derive_terms`` divides by the H100's datasheet peaks (989.4
    TFLOP/s bfloat16, 3.35 TB/s, 450 GB/s NVLink a direction);
    ``model_flops`` and ``active_param_count`` equal the reference's."""
    assert (troofline.PEAK_FLOPS_BF16, troofline.HBM_BW,
            troofline.NVLINK_BW) == (989.4e12, 3.35e12, 450e9)
    j, t = jconfigs.get_config("olmo-1b"), tconfigs.get_config("olmo-1b")
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    assert t.model.active_param_count() == j.model.active_param_count()
    mf = troofline.model_flops(t, ts)
    assert mf == jroofline.model_flops(j, js)
    kind = _step_kinds(ts.kind)[-1]
    c = tflops.analytic_costs(t, ts, make_mesh((2, 4), ("data", "model")),
                              step_kind=kind[0], collective_mode=kind[1])
    r = troofline.derive_terms(
        flops_per_device=c.total_flops, bytes_per_device=c.total_bytes,
        collective_bytes_per_device=c.total_collective, num_devices=8,
        model_flops_global=mf)
    assert r.compute_s == c.total_flops / 989.4e12
    assert r.memory_s == c.total_bytes / 3.35e12
    assert r.collective_s == c.total_collective / 450e9
    assert r.bound_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert r.dominant == max(("compute", r.compute_s), ("memory", r.memory_s),
                             ("collective", r.collective_s),
                             key=lambda x: x[1])[0]
    assert r.useful_flops_ratio == mf / (c.total_flops * 8)
    want = jroofline.derive_terms(
        flops_per_device=c.total_flops, bytes_per_device=c.total_bytes,
        collective_bytes_per_device=c.total_collective, num_devices=8,
        model_flops_global=mf).as_dict()
    got = r.as_dict()
    assert set(got) == set(want)
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "model_flops_global",
                "hlo_flops_global", "useful_flops_ratio"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_zoo_analytic_costs_match_exactly(arch, shape):
    """deepseek-v3-671b (MLA, a shared expert, MTP), whisper-base (the
    encoder-decoder) and chameleon-34b (vlm), full and reduced:
    ``analytic_costs`` at the shape (``for_shape``) equal to the
    reference's field by field over the three meshes and every step kind
    and mode; whisper has no long_500k, and ``for_shape`` raises there as
    the reference's does."""
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    for reduce in (False, True):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        if reduce:
            j, t = jconfigs.reduced(j), tconfigs.reduced(t)
        if not jconfigs.supports_shape(j, js):
            assert arch == "whisper-base" and shape == "long_500k"
            with pytest.raises(ValueError, match="does not support"):
                tconfigs.for_shape(t, ts)
            continue
        j, t = jconfigs.for_shape(j, js), tconfigs.for_shape(t, ts)
        assert t.model.param_count() == j.model.param_count()
        assert t.model.active_param_count() == j.model.active_param_count()
        for sizes, axes in MESHES:
            jmesh = types.SimpleNamespace(shape=dict(zip(axes, sizes)))
            for step_kind, mode in _step_kinds(js.kind):
                want = jflops.analytic_costs(j, js, jmesh,
                                             step_kind=step_kind,
                                             collective_mode=mode)
                got = tflops.analytic_costs(t, ts, make_mesh(sizes, axes),
                                            step_kind=step_kind,
                                            collective_mode=mode)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                    reduce, sizes, step_kind, mode)


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_zoo_serving_inputs_and_cache_match(arch, shape):
    """``launch.inputs`` for the three: the (B, S) prompt, whisper's
    (B, 1500, 512) frames in the model's dtype beside it, the (B, 1)
    token; the cache at the shape has the reference's leaves' shapes and
    dtypes (deepseek's latent (61, B, C, 576), whisper's self and cross
    k and v), built on the meta device."""
    js, ts = jshapes.SHAPES[shape], tshapes.SHAPES[shape]
    jcfg = jconfigs.for_shape(jconfigs.get_config(arch), js)
    tcfg = tconfigs.for_shape(tconfigs.get_config(arch), ts)
    mesh = jcompat.make_mesh((1, 1), ("data", "model"))
    structs, _ = jinputs.prefill_specs(jcfg, js, mesh)
    assert tinputs.prefill_shape(ts) == structs[0].shape
    if tcfg.model.is_encoder_decoder:
        assert tinputs.frames_shape(tcfg, ts.global_batch) == structs[1].shape
        frames = tinputs.random_frames(tcfg, 2,
                                       torch.Generator().manual_seed(0))
        assert frames.shape == (2, 1500, 512) and frames.dtype == torch.float32
    else:
        assert len(structs) == 1
    jmodel = jbuild_model(jcfg)
    (jcache, jtok), _ = jinputs.decode_specs(jmodel, jcfg, js, mesh)
    assert tinputs.decode_shape(ts) == jtok.shape
    tcache = build_model(tcfg).init_cache(js.global_batch, js.seq_len,
                                             device="meta")
    if "layers" in jcache:
        want = {"latent" if tcfg.model.mla.enabled else "k":
                jcache["layers"] if tcfg.model.mla.enabled
                else jcache["layers"][0]}
        if not tcfg.model.mla.enabled:
            want["v"] = jcache["layers"][1]
        want.update(kv_pos=jcache["kv_pos"], length=jcache["length"])
    else:
        want = jcache
    assert set(tcache) == set(want)
    for name, w in want.items():
        assert tuple(tcache[name].shape) == w.shape, name
        assert str(tcache[name].dtype).removeprefix("torch.") == str(w.dtype)
