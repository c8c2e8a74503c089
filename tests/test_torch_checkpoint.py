"""Checkpoints (``repro_torch.checkpoint``, ``population.fleet``'s restore)
against the reference's ``repro.checkpoint`` and the trainer's
``--checkpoint-dir`` / ``--telemetry-dir`` gate.

The port writes the reference's msgpack layout with a codec of its own
(the card's machine has no ``msgpack``): its files are held byte for byte
to the reference's, which is ``msgpack.packb``, and each package restores
the other's checkpoints bit for bit.

The trainer's gate follows the reference's resume semantics: a resumed
run restarts its generator at ``fl.seed + 1`` (the reference restarts its
key chain at ``PRNGKey(fl.seed + 1)``), so 2 steps, a resume and 2 more
equal the checkpoint of step 2 followed by 2 steps from a fresh generator,
not 4 uninterrupted steps.
"""
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.config.base import apply_overrides as japply
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.obs import sinks as jsinks
from repro.population import fleet as jfleet
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.core.fl import resolve_collective
from repro_torch.data.synthetic import token_batch
from repro_torch.device import make_generator
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.population import fleet as tfleet

SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
         "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512",
         "train.global_batch=8", "train.seq_len=32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(name):
    """The same leaves for both packages: (numpy/jax tree, torch tree)."""
    rng = np.random.default_rng(3)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    if name == "mixed":
        leaves = {"w": f32(3, 4), "bf": f32(5), "i": rng.integers(
                      -9, 9, 7).astype(np.int32), "s": np.float32(2.5),
                  "k": np.int32(-3), "wide": f32(70_000), "tall": f32(300, 2)}
        bf = {"bf"}
    else:     # "many": 20 leaves, the outer array past msgpack's fixarray
        leaves = {f"l{i:02d}": f32(i + 1) for i in range(20)}
        bf = {"l03", "l17"}
    jtree = {k: (jnp.asarray(v, jnp.bfloat16) if k in bf else jnp.asarray(v))
             for k, v in leaves.items()}
    ttree = {k: (torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
                 if k in bf else torch.from_numpy(np.asarray(v)))
             for k, v in leaves.items()}
    return jtree, ttree


def _same(tleaf, jleaf):
    """Equal in dtype, shape and bits (bfloat16 compared as its uint16)."""
    a = np.asarray(jleaf)
    if tleaf.dtype == torch.bfloat16:
        return (a.dtype.name == "bfloat16" and np.array_equal(
            tleaf.view(torch.int16).numpy(), a.view(np.int16)))
    return (tleaf.numpy().dtype == a.dtype and tleaf.shape == a.shape
            and np.array_equal(tleaf.numpy(), a))


@pytest.mark.parametrize("name", ["mixed", "many"])
def test_files_equal_the_references_bytes(tmp_path, name):
    """float32, bfloat16, int32, 0-dim leaves, a dim >= 65,536 (a uint32
    in the shape, a 32-bit bin length) and 20 leaves: the port's file is
    the reference's, which is ``msgpack.packb`` of its leaves."""
    jtree, ttree = _trees(name)
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 5, ttree)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 5, jtree)
    got = open(tpath, "rb").read()
    want = msgpack.packb([jckpt._encode(v) for v in
                          jax.tree_util.tree_leaves(jtree)], use_bin_type=True)
    assert got == want
    assert open(jpath, "rb").read() == want
    back = tckpt.restore_checkpoint(str(tmp_path / "j"), ttree)
    assert list(back) == list(ttree)
    assert all(_same(back[k], jtree[k]) for k in ttree)
    jback = jckpt.restore_checkpoint(str(tmp_path / "t"), jtree)
    assert all(_same(ttree[k], jback[k]) for k in ttree)


@pytest.mark.parametrize("arch", ["olmo-1b", "mnist_cnn"])
def test_parameters_cross_both_ways(tmp_path, arch):
    """Reduced olmo-1b (bfloat16) and the QNN (float32): the reference's
    checkpoint restores into the port's flat vector bit for bit, and the
    port's into the reference's tree."""
    jcfg = jget_config(arch)
    cfg = get_config(arch)
    if arch == "olmo-1b":
        jcfg = japply(jreduced(jcfg), SMALL)
        cfg = apply_overrides(reduced(cfg), SMALL)
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_leaves(jp)
    assert {str(x.dtype) for x in leaves} == {
        "bfloat16" if arch == "olmo-1b" else "float32"}
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  dtype=model.dtype, device="cpu")
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jp)
    template = torch.zeros_like(flat)
    got = tckpt.restore_params(str(tmp_path / "j"), template,
                               model.param_shapes)
    assert got.dtype == model.dtype and torch.equal(got, flat)
    assert torch.equal(template, torch.zeros_like(flat))

    moved = flat + 1
    tckpt.save_params(str(tmp_path / "t"), 2, moved, model.param_shapes)
    jback = jckpt.restore_checkpoint(str(tmp_path / "t"), jp)
    back = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jback),
                                  dtype=model.dtype, device="cpu")
    assert torch.equal(back, moved)
    assert [x.dtype for x in jax.tree_util.tree_leaves(jback)] == \
        [x.dtype for x in leaves]


def _fleets():
    """A reference fleet after one lyapunov round and the port's copy."""
    cfg = jget_config("mnist_cnn")
    cfg = japply(cfg, ("fleet.size=32", "fleet.selection=lyapunov",
                       "power.policy=lyapunov"))
    st = jfleet.init_fleet(jax.random.PRNGKey(0), cfg)
    st, _ = jfleet.round_update(st, jax.random.PRNGKey(1), cfg, 1000, 4)
    port = convert.fleet_from_numpy(
        {k: np.asarray(v) for k, v in st._asdict().items()}, device="cpu")
    return st, port


def _fleet_equal(port, ref):
    return all(np.array_equal(getattr(port, f).numpy(),
                              np.asarray(getattr(ref, f)))
               and getattr(port, f).numpy().dtype == np.asarray(
                   getattr(ref, f)).dtype
               for f in tfleet.FleetState._fields)


def test_fleet_round_trips_through_both_packages(tmp_path):
    st, port = _fleets()
    assert float(port.p_last.max()) > 0
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, port)
    ref = jfleet.restore_fleet_checkpoint(str(tmp_path / "t"), st)
    assert isinstance(ref, jfleet.FleetState) and _fleet_equal(port, ref)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, st)
    template = tfleet.init_fleet(5, _port_fleet_cfg(), device="cpu")
    got = tfleet.restore_fleet_checkpoint(str(tmp_path / "j"), template)
    assert isinstance(got, tfleet.FleetState) and _fleet_equal(got, st)
    assert open(tmp_path / "t" / "ckpt_7.msgpack", "rb").read() == \
        open(tmp_path / "j" / "ckpt_7.msgpack", "rb").read()


def _port_fleet_cfg():
    """The port's config of ``_fleets``' fleet (for templates)."""
    return apply_overrides(get_config("mnist_cnn"), (
        "fleet.size=32", "fleet.selection=lyapunov", "power.policy=lyapunov"))


def test_legacy_fleet_written_by_the_reference_migrates(tmp_path):
    """As ``tests/test_power.py``'s legacy case: a 6-leaf fleet the
    reference wrote restores with its fields bit for bit, capacity = the
    restored battery, unit harvest scale, zero ``p_last``."""
    st, _ = _fleets()
    legacy = jfleet._LegacyFleetState(
        **{f: getattr(st, f) for f in jfleet._LegacyFleetState._fields})
    jckpt.save_checkpoint(str(tmp_path), 3, legacy)
    template = tfleet.init_fleet(5, _port_fleet_cfg(), device="cpu")
    got = tfleet.restore_fleet_checkpoint(str(tmp_path), template)
    assert isinstance(got, tfleet.FleetState)
    for f in tfleet._LegacyFleetState._fields:
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(st, f))), f
    assert torch.equal(got.capacity_j, got.battery_j)
    assert torch.equal(got.harvest_scale, torch.ones(32))
    assert torch.equal(got.p_last, torch.zeros(32))
    assert got.rr_cursor.dtype == torch.int32 and got.rr_cursor.shape == ()


def test_retention_keeps_three_and_latest_step(tmp_path):
    d = str(tmp_path / "c")
    assert tckpt.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, s, {"a": torch.arange(s, dtype=torch.int32)})
    assert sorted(os.listdir(d)) == ["ckpt_3.msgpack", "ckpt_4.msgpack",
                                     "ckpt_5.msgpack"]
    assert tckpt.latest_step(d) == 5
    tmpl = {"a": torch.zeros(4, dtype=torch.int32)}
    assert torch.equal(tckpt.restore_checkpoint(d, tmpl, 4)["a"],
                       torch.arange(4, dtype=torch.int32))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), tmpl)


def test_a_wrong_template_raises(tmp_path):
    """A template with another leaf count or leaf shape raises ValueError
    (the fleet's migration needs it), and so does a parameter leaf of
    another dtype than the model's."""
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(d, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(d, {"a": torch.zeros(3), "b": torch.zeros(4)})
    shapes = convert.Layout.uniform({"a": (3,), "b": (2,)}, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.restore_params(d, torch.zeros(5, dtype=torch.bfloat16), shapes)
    assert torch.equal(tckpt.restore_params(d, torch.ones(5), shapes),
                       torch.zeros(5))


def _trainer_cli(ckpt_dir, tel_dir, steps):
    return ["--arch", "olmo-1b", "--devices", "8", "--fleet-size", "64",
            "--log-every", "1", "--steps", str(steps),
            "--checkpoint-dir", ckpt_dir, "--checkpoint-every", "2",
            "--telemetry-dir", tel_dir, *SMALL]


def test_trainer_resumes_as_the_reference_does(tmp_path, capsys):
    """Run A: 2 steps, saving at step 2 and streaming telemetry; run B: 4
    steps on the same directories.  B's ``ckpt_4`` equals ``ckpt_2``
    followed by 2 steps of ``make_train_step`` from a fresh
    ``make_generator(fl.seed + 1)``, in parameters and fleet; the stream
    holds rounds 0-3, each valid under the reference's schema."""
    c, t = str(tmp_path / "ckpt"), str(tmp_path / "tel")
    a = ttrain.main(_trainer_cli(c, t, 2), device="cpu")
    assert a["start_step"] == 0 and a["telemetry_records"] == 2
    b = ttrain.main(_trainer_cli(c, t, 4), device="cpu")
    assert b["start_step"] == 2 and b["steps"] == 4
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    assert "restored fleet state step 2" in out

    cfg = apply_overrides(get_config("olmo-1b"), SMALL + ("fleet.size=64",))
    model = build_model(cfg)
    step_fn, kind = tsteps.make_train_step(
        model, cfg, tmesh.mesh_for_devices(8),
        collective=resolve_collective(cfg, None), device="cpu")
    assert kind == "fleet_fl_round"
    init = model.init_flat(cfg.fl.seed, device="cpu")
    params = tckpt.restore_params(c, init, model.param_shapes, step=2)
    fleet0 = tfleet.init_fleet(cfg.fleet.seed, cfg, device="cpu")
    fleet = tfleet.restore_fleet_checkpoint(os.path.join(c, "fleet"), fleet0,
                                            step=2)
    gen = make_generator(cfg.fl.seed + 1, torch.device("cpu"))
    for _ in range(2):
        batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                            cfg.model.vocab_size)
        params, _, fleet = step_fn(params, batch, gen, fleet)
    saved = tckpt.restore_params(c, init, model.param_shapes, step=4)
    saved_fleet = tfleet.restore_fleet_checkpoint(os.path.join(c, "fleet"),
                                                  fleet0, step=4)
    assert torch.equal(saved, params) and torch.equal(b["params"], params)
    assert all(torch.equal(x, y) for x, y in zip(saved_fleet, fleet))
    assert not torch.equal(saved, tckpt.restore_params(
        c, init, model.param_shapes, step=2))

    with open(os.path.join(t, "telemetry.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["round"] for r in records] == [0, 1, 2, 3]
    for r in records:
        assert jsinks.validate_record(r) == [], r
        assert r["kind"] == "train_step" and "battery_q50_j" in r
