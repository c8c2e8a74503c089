"""The cohort round over the dense LM and the trainer's entry point
(``repro_torch.launch.{mesh,steps,train}``) against the reference.

The round is held to the real JAX ``make_fl_round`` on a (4,) host mesh
in a subprocess, on olmo-1b at the size of the reference's trainer test,
with the reference's own key-chain draws (uplink noise and packet drops;
the LM's local steps draw nothing).  Bounds, with what a CPU run
measured (JAX 0.9.0, torch 2.13):

* float32, 8 bits, q = 0.3 (two of four cohorts dropped), int and rsag:
  as ROADMAP C4 holds the QNN — every parameter within one uplink code
  step (1/128), at least 99.9 % within 1e-5, the loss within rtol 1e-4
  (measured: bit for bit, loss 1e-7 relative);
* float32, bits = 0 and q = 0 (the float uplink): every parameter within
  1e-6 (measured 7.5e-8).  The float32 step now rounds once, as the
  reference's (ROADMAP C5), and the measurement is unchanged: 34 % of the
  parameters still differ, by up to 7.45e-8, because the LM's gradient
  sums run in ATen's order and not XLA's (as C4 for the QNN), so the
  bound stays;
* bfloat16, int: the local steps' bfloat16 products sum in another order,
  so at least 99 % of the parameters equal and every one within a code
  step and one bfloat16 ulp, the loss within rtol 1e-3 (measured 99.4 %
  equal, at most 1/128 apart, loss 2.7e-5 relative).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import apply_overrides as japply
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch.steps import make_standard_train_step as jstandard_step
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import common as tcommon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
         "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512")
C, I, B, Q, LR = 4, 2, 16, 0.3, 0.5
ROUND = SMALL + ("model.dtype=float32", "train.seq_len=32",
                 f"channel.error_prob={Q}", f"fl.local_iters={I}",
                 f"fl.learning_rate={LR}", f"train.global_batch={B}")
#: the round's float runs and their config overrides on top of ROUND
RUNS = {"int": (), "rsag": (), "paper_f32": ("quant.bits=0",
                                             "channel.error_prob=0.0"),
        "int_bf16": ("model.dtype=bfloat16",)}
CLI = ["--arch", "olmo-1b", "--steps", "2", "--log-every", "1", *SMALL,
       "train.global_batch=8", "train.seq_len=32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(*extra):
    return apply_overrides(reduced(get_config("olmo-1b")), ROUND + extra)


_JAX_ROUND = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.config.base import apply_overrides
from repro.configs import get_config, reduced
from repro.core import channel as ch
from repro.core.fl import make_fl_round
from repro.models import build_model
from repro.utils.compat import make_mesh, set_mesh

C, Q, SEED = {C}, {Q}, 5
base = apply_overrides(reduced(get_config("olmo-1b")), {ROUND!r})
runs = {RUNS!r}
mesh = make_mesh((C,), ("data",))
flat = lambda p: np.concatenate([np.asarray(x, np.float32).ravel()
                                 for x in jax.tree_util.tree_leaves(p)])
data = np.random.default_rng(0)
tok = data.integers(0, 512, ({B}, 32)).astype(np.int32)
batch = {{"tokens": tok, "labels": np.roll(tok, -1, 1)}}
rng = jax.random.PRNGKey(SEED)
out = dict(batch)
with set_mesh(mesh):
    for name, extra in runs.items():
        cfg = apply_overrides(base, extra)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(1))
        out[name + "/init"] = flat(params)
        fn = jax.jit(make_fl_round(model, cfg, mesh,
                                   collective=name.split("_")[0]))
        new, m = fn(params, batch, rng)
        out[name + "/params"] = flat(new)
        for k in ("loss", "survivors", "wire_bits_per_param"):
            out[name + "/" + k] = np.float32(m[k])
leaves = jax.tree_util.tree_leaves(params)

def leaf_noise(key):      # split(key, n_leaves), one uniform draw per leaf
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.uniform(
        k, x.shape, jnp.float32)).ravel() for k, x in zip(keys, leaves)])

u_up, lam = [], []
for c in range(C):        # the round's key chain: _shard_rng, local_round
    rc = jax.random.fold_in(rng, c)
    lam.append(float(ch.sample_packet_success(jax.random.fold_in(rc, 11), (), Q)))
    u_up.append(leaf_noise(jax.random.fold_in(rc, 13)))
np.savez(sys.argv[1], u_up=np.array(u_up), lam=np.array(lam, np.float32), **out)
"""


def test_lm_round_matches_the_real_make_fl_round(tmp_path):
    """The real JAX round at (4,) against the port's on the CPU, fed the
    reference's parameters and draws, within the bounds of the module
    docstring; survivors and wire bits equal."""
    path = tmp_path / "round.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    code = textwrap.dedent(_JAX_ROUND).format(C=C, Q=Q, B=B, ROUND=ROUND,
                                              RUNS=RUNS)
    r = subprocess.run([sys.executable, "-c", code, str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    z = np.load(path)
    assert 0 < z["lam"].sum() < C
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    for name, extra in RUNS.items():
        cfg = _cfg(*extra)
        model = build_model(cfg)
        params = torch.from_numpy(z[name + "/init"]).to(model.dtype)
        lam = torch.from_numpy(z["lam"])
        if cfg.channel.error_prob == 0.0:
            lam = torch.ones(C)
        fn = make_fl_round(model, cfg, (C,), collective=name.split("_")[0],
                           device="cpu")
        new, m = fn(params, batch,
                    noise=RoundNoise(None, torch.from_numpy(z["u_up"]), lam))
        got, want = new.float().numpy(), z[name + "/params"]
        diff = np.abs(got - want)
        assert float(m["survivors"]) == z[name + "/survivors"], name
        assert np.float32(m["wire_bits_per_param"]) == \
            z[name + "/wire_bits_per_param"], name
        assert np.abs(want - z[name + "/init"]).max() > 1 / 128, name
        if name == "paper_f32":
            assert diff.max() <= 1e-6, (name, diff.max())
            np.testing.assert_allclose(float(m["loss"]), z[name + "/loss"],
                                       rtol=1e-4)
        elif name == "int_bf16":
            ulp = np.abs(want) * 2.0 ** -7
            assert np.all(diff <= 1 / 128 + ulp), (name, diff.max())
            assert (diff == 0).mean() >= 0.99, (name, (diff == 0).mean())
            np.testing.assert_allclose(float(m["loss"]), z[name + "/loss"],
                                       rtol=1e-3)
        else:
            assert diff.max() <= 1 / 128 + 1e-7, (name, diff.max())
            assert (diff <= 1e-5).mean() >= 0.999, (name, (diff <= 1e-5).mean())
            np.testing.assert_allclose(float(m["loss"]), z[name + "/loss"],
                                       rtol=1e-4)


def _port_inputs(cfg, seed=0):
    model = build_model(cfg)
    params = model.init_flat(1, device="cpu")
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, 512, (B, 32)).astype(np.int32))
    return model, params, {"tokens": tok, "labels": torch.roll(tok, -1, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_modes_give_equal_params(dtype):
    """From one generator, int, packed, ring (both front-ends), rsag and
    auto give the same new parameters to the last bit at (4,), and int,
    ring and rsag at (2, 2) give those too; no STE launch is needed, so
    the LM's round draws no fake-quant noise."""
    cfg = _cfg(f"model.dtype={dtype}")
    model, params, batch = _port_inputs(cfg)
    out = {}
    for sizes, mode, hops in (((4,), "int", True), ((4,), "packed", True),
                              ((4,), "ring", True), ((4,), "ring", False),
                              ((4,), "rsag", True), ((4,), "auto", True),
                              ((2, 2), "int", True), ((2, 2), "ring", True),
                              ((2, 2), "rsag", True)):
        c = dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, pipeline_hops=hops))
        fn = make_fl_round(model, c, sizes, collective=mode, device="cpu")
        new, m = fn(params, batch, torch.Generator().manual_seed(0))
        assert float(m["survivors"]) == 2.0          # on this seed
        assert new.dtype == params.dtype and bool(torch.isfinite(new).all())
        assert np.isfinite(float(m["loss"]))
        out[sizes, mode, hops] = new
    want = out[(4,), "int", True]
    assert not torch.equal(want, params)
    for key, got in out.items():
        assert torch.equal(got, want), key


def test_round_checks_the_parameters_dtype():
    cfg = _cfg()
    model, params, batch = _port_inputs(cfg)
    fn = make_fl_round(model, cfg, (4,), collective="int", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        fn(params.to(torch.bfloat16), batch, torch.Generator())


@pytest.mark.parametrize("collective", ["paper", "int", "packed", "ring",
                                        "rsag", "auto"])
def test_train_main_runs_each_collective(collective, capsys):
    """``main`` on the reference's (2, 4) debug mesh for 8 devices: 2
    cohorts stacked, a finite loss in every wire format."""
    out = ttrain.main(CLI + ["--devices", "8", "--collective", collective],
                      device="cpu")
    assert out["kind"] == "fl_round" and out["steps"] == 2
    assert out["mesh"] == {"data": 2, "model": 4} and out["cohorts"] == 2
    assert np.isfinite(out["loss"]) and out["params_finite"]
    assert out["survivors"] == 2.0
    printed = capsys.readouterr().out
    assert "step kind: fl_round" in printed and "done: 2 steps" in printed


def test_train_main_fleet_and_standard_kinds(capsys):
    """The fleet flags give the fleet round; cohort axes absent from the
    mesh give the standard step; one device gives one cohort."""
    fleet = ttrain.main(CLI + ["--devices", "8", "--fleet-size", "64",
                               "--selection", "rate_aware",
                               "--power-policy", "fbl_target"], device="cpu")
    assert fleet["kind"] == "fleet_fl_round" and np.isfinite(fleet["loss"])
    std = ttrain.main(CLI + ["--devices", "8", "fl.cohort_axes=pod"],
                      device="cpu")
    assert std["kind"] == "standard" and np.isfinite(std["loss"])
    one = ttrain.main(CLI, device="cpu")
    assert one["mesh"] == {"data": 1, "model": 1} and one["cohorts"] == 1
    assert "fleet: 64 devices" in capsys.readouterr().out


def test_standard_step_matches_the_references():
    """One standard SGD step on the reference's float32 parameters against
    its ``make_standard_train_step``: within 1e-6 (lr 0.5; the gradients
    agree within 1e-5 of their largest entry, ``test_torch_lm.py``)."""
    jcfg = japply(jreduced(jget_config("olmo-1b")), ROUND)
    jmodel = jbuild_model(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 512, (4, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    jnew, jm = jax.jit(jstandard_step(jmodel, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    cfg = _cfg()
    model = build_model(cfg)
    flat = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    step = tsteps.make_standard_train_step(model, cfg, device="cpu")
    new, m = step(flat, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = convert.flat_from_tree(jax.tree_util.tree_map(np.asarray, jnew),
                                  device="cpu")
    assert float((new - want).abs().max()) <= 1e-6
    assert float((want - flat).abs().max()) > 1e-3
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-6)
    assert torch.equal(flat, convert.flat_from_tree(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


def test_meshes_are_the_references():
    """The axis sizes of ``repro.launch.mesh`` and of the trainer's choice
    of mesh for N devices (``repro/launch/train.py``)."""
    assert tmesh.make_debug_mesh(8) == {"data": 2, "model": 4}
    assert tmesh.make_production_mesh() == {"data": 16, "model": 16}
    assert tmesh.make_production_mesh(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert [tmesh.mesh_for_devices(n) for n in (1, 3, 8, 10, 256, 512)] == [
        {"data": 1, "model": 1}, {"data": 1, "model": 1},
        {"data": 2, "model": 4}, {"data": 2, "model": 4},
        {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
    assert tmesh.cohort_axis_sizes(tmesh.make_production_mesh(multi_pod=True),
                                   ("pod", "data")) == (2, 16)
    with pytest.raises(ValueError):
        tmesh.make_debug_mesh(6)


def test_make_train_step_kinds():
    cfg = _cfg()
    model = build_model(cfg)
    mesh = tmesh.make_debug_mesh(8)
    assert tsteps.make_train_step(model, cfg, mesh, device="cpu")[1] == "fl_round"
    fleet = apply_overrides(cfg, ("fleet.size=16",))
    assert tsteps.make_train_step(model, fleet, mesh,
                                  device="cpu")[1] == "fleet_fl_round"
    assert tsteps.make_train_step(model, cfg, mesh, force_standard=True,
                                  device="cpu")[1] == "standard"


def test_entry_points_raise_without_cuda(monkeypatch):
    """Without a CUDA device the entry points raise and name the CPU
    option."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg()
    model = build_model(cfg)
    for call in (lambda: ttrain.main(CLI),
                 lambda: tsteps.make_train_step(model, cfg,
                                                tmesh.make_debug_mesh(8)),
                 lambda: tsteps.make_standard_train_step(model, cfg),
                 lambda: model.init_flat(0),
                 lambda: tcommon.make_norm_params(cfg.model, 8),
                 lambda: tcommon.rope_frequencies(16, 500.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
