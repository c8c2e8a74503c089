"""The port's cohort round (``repro_torch.core.fl.make_fl_round``) and its
wire formats (``repro_torch.core.aggregation.aggregate``) against the
reference.

The reference's collective runs one cohort per mesh shard.  Its own
``agg.aggregate`` runs unchanged under ``jax.vmap(..., axis_name="data")``
on one CPU device — ``psum``, ``ppermute`` and ``axis_index`` batch under
``vmap`` — which is the cohort-stacked form the port computes; the port is
fed the reference's rounding noise (``aggregation._flat_noise`` of each
cohort's key).  The whole round is held to the real ``make_fl_round`` on a
4-device host mesh in a subprocess, on the reference's own key-chain
draws.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.config.base import QuantConfig
from repro_torch.configs import get_config
from repro_torch.core import aggregation as tagg
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = {"a": (1003,), "b": (3, 17)}     # a two-leaf delta, 1,054 values
D = sum(int(np.prod(s)) for s in LEAVES.values())


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.config.base import QuantConfig as JQuantConfig
    from repro.core import aggregation as agg
    return types.SimpleNamespace(jax=jax, jnp=jnp, agg=agg,
                                 QuantConfig=JQuantConfig)


def _reference(jx, mode, qcfg, C):
    """The reference's ``aggregate`` over C cohorts stacked by ``vmap``:
    (delta tree with (C, ...) leaves, lam (C,), keys (C, 2)) -> (the
    aggregated delta of every cohort (C, D), the uplink noise (C, D))."""
    jax, jnp = jx.jax, jx.jnp
    plan = jx.agg.make_wire_plan(mode, qcfg, ("data",), (C,))

    def one(delta, lam, key):
        out = jx.agg.aggregate(plan, delta, jnp.float32(1.0 / C), lam, key)
        leaves = jax.tree_util.tree_leaves(delta)
        u = jx.agg._flat_noise(leaves, jax.random.split(key, len(leaves)))
        return jnp.concatenate([out[k].ravel() for k in sorted(out)]), u

    return jax.jit(jax.vmap(one, axis_name="data"))


def _cohort_inputs(jx, C, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    delta = {k: rng.normal(0.0, scale, (C,) + s).astype(np.float32)
             for k, s in LEAVES.items()}
    flat = np.concatenate([delta[k].reshape(C, -1) for k in sorted(delta)], 1)
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(seed), C)
    lam_some = np.ones(C, np.float32)
    lam_some[1::2] = 0.0                   # every other cohort dropped
    return delta, flat, keys, (lam_some, np.zeros(C, np.float32))


def _port(mode, qcfg, C, flat, lam, u):
    plan = tagg.make_wire_plan(mode, qcfg, ("data",), (C,))
    return tagg.aggregate(plan, torch.from_numpy(flat), 1.0 / C,
                          torch.from_numpy(lam), torch.tensor(u))


@pytest.mark.parametrize("C", [2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["paper", "int", "packed", "ring"])
def test_aggregate_bit_exact_with_reference_at_clip_1(jx, mode, C):
    """At clip 1.0 every mode equals the reference's to the last bit, with
    some and with all cohorts dropped, at bits {2, 8} and both roundings;
    the ring with either ``pipeline_hops`` schedule.

    One exception: "paper" sums the weighted f32 deltas, and the
    reference's CPU backend fuses that multiply into the sum as an FMA
    (one rounding where the port rounds twice).  Where the weight 1/C is
    inexact (C = 3, 5) that moves the last bit of a partial sum; every
    term is at most 1 (the clip) and the sum is divided by the surviving
    weight, so "paper" is held within 4 ulp of 1.0 (4.8e-7) there."""
    delta, flat, keys, lams = _cohort_inputs(jx, C, seed=C)
    exact = mode != "paper" or C in (2, 4)
    for bits, stochastic in itertools.product((2, 8), (True, False)):
        q = QuantConfig(bits=bits, stochastic=stochastic)
        ref = _reference(jx, mode, jx.QuantConfig(bits=bits,
                                                  stochastic=stochastic), C)
        for lam in lams:
            want, u = ref({k: jx.jnp.asarray(v) for k, v in delta.items()},
                          jx.jnp.asarray(lam), keys)
            want, u = np.asarray(want), np.array(u)
            got = _port(mode, q, C, flat, lam, u)
            assert got.shape == (D,) and got.dtype == torch.float32
            for c in range(C):                 # every cohort holds the sum
                if exact:
                    np.testing.assert_array_equal(got.numpy(), want[c])
                else:
                    np.testing.assert_allclose(
                        got.numpy(), want[c], rtol=0,
                        atol=4 * np.spacing(np.float32(1)))
            if mode == "ring":
                seq = _port(mode, dataclasses.replace(q, pipeline_hops=False),
                            C, flat, lam, u)
                assert torch.equal(seq, got)
            if not lam.any():
                assert not got.any()


@pytest.mark.parametrize("C", [3, 4])
def test_aggregate_at_clip_0_3_modes_equal_and_within_2_ulp(jx, C):
    """At a clip that is not a power of two the port's quantized modes stay
    ``torch.equal`` with each other (every mode dequantizes by the same
    multiply); the reference's pure modes divide, so each is held within
    2 ulp of the reference's same mode.  "paper" sums floats, so it is held
    as in the clip-1 test, within 4 ulp of 1.0 (the FMA there, and here the
    reference's dequantizing divide)."""
    delta, flat, keys, lams = _cohort_inputs(jx, C, seed=10 + C, scale=0.1)
    q = QuantConfig(bits=8, clip=0.3)
    lam = lams[0]
    got = {}
    for mode in ("paper", "int", "packed", "ring"):
        ref = _reference(jx, mode, jx.QuantConfig(bits=8, clip=0.3), C)
        want, u = ref({k: jx.jnp.asarray(v) for k, v in delta.items()},
                      jx.jnp.asarray(lam), keys)
        want, u = np.asarray(want)[0], np.array(u)
        got[mode] = _port(mode, q, C, flat, lam, u)
        if mode == "paper":
            np.testing.assert_allclose(got[mode].numpy(), want, rtol=0,
                                       atol=4 * np.spacing(np.float32(1)))
        else:
            assert np.all(np.abs(got[mode].numpy() - want)
                          <= 2 * np.spacing(np.abs(want))), mode
    got["ring/sequential"] = _port("ring", dataclasses.replace(
        q, pipeline_hops=False), C, flat, lam, u)
    for mode in ("packed", "ring", "ring/sequential"):
        assert torch.equal(got[mode], got["int"]), mode


def test_ring_accumulator_rows_all_hold_the_sum():
    """Each row r adds rows r-1, ..., r-(C-1): every row ends with the code
    sum, under either front-end."""
    C, n = 5, 301
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.2, (C, n)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (C, n)).astype(np.float32))
    codes = torch.stack([torch.floor(torch.clamp(x[c], -1, 1) * 128 + u[c])
                         for c in range(C)]).clamp(-128, 127).to(torch.int32)
    for hops in (True, False):
        plan = tagg.make_wire_plan("ring", QuantConfig(pipeline_hops=hops),
                                   ("data",), (C,))
        acc = tagg.ring_sum(plan, x, u)
        for r in range(C):
            assert torch.equal(acc[r], codes.sum(0, dtype=torch.int32))


def _cfg(C=4, I=2, batch=16, q=0.3, **quant):
    cfg = get_config("mnist_cnn")
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, **quant),
        channel=dataclasses.replace(cfg.channel, error_prob=q),
        fl=dataclasses.replace(cfg.fl, local_iters=I, learning_rate=0.05),
        train=dataclasses.replace(cfg.train, global_batch=batch))


def test_rsag_two_axis_ring_and_auto_to_rsag_raise(monkeypatch):
    """rsag, a two-level ring and an "auto" that resolves to rsag used to
    raise here until ``pack_sums`` was ported; now each builds and runs a
    round, and nothing of the wire raises ``NotImplementedError``.  Under
    the cost model (the reference's, equal to the port's by
    ``test_torch_pack.py``) no layout of the grid below makes "auto" pick
    rsag, so the "auto" case forces that pick."""
    layouts = ([(k,) for k in range(2, 257)] + [(2 ** e,) for e in range(9, 12)]
               + [(p, k) for p in range(2, 9) for k in range(2, 33)])
    assert not [(b, s) for b in (1, 2, 4, 8, 12, 16, 24) for s in layouts
                if tagg.resolve_auto(QuantConfig(bits=b), s) == "rsag"]
    model, params, batch = _round_inputs(C=4, batch=16)

    def runs(sizes, mode):
        fn = make_fl_round(model, _cfg(), sizes, collective=mode, device="cpu")
        new, m = fn(params, batch, torch.Generator().manual_seed(1))
        assert new.shape == params.shape and bool(torch.isfinite(new).all())
        return m["wire_bits_per_param"]

    assert runs((4,), "rsag") == tagg.wire_bits_per_param(
        "rsag", QuantConfig(), (4,))
    assert runs((2, 2), "ring") == tagg.wire_bits_per_param(
        "ring", QuantConfig(), (2, 2))
    monkeypatch.setattr(tagg, "resolve_auto", lambda qcfg, sizes: "rsag")
    assert runs((4,), "auto") == tagg.wire_bits_per_param(
        "rsag", QuantConfig(), (4,))
    monkeypatch.undo()
    plan = tagg.make_wire_plan("rsag", QuantConfig(), ("data",), (2,))
    out = tagg.aggregate(plan, torch.zeros(2, 5), 0.5, torch.ones(2),
                         torch.zeros(2, 5))
    assert torch.equal(out, torch.zeros(5))
    # a ring with one non-trivial axis among trivial ones runs
    assert make_fl_round(model, _cfg(), (1, 4), collective="ring",
                         device="cpu") is not None
    assert make_fl_round(model, _cfg(), (), device="cpu") is None


def test_make_fl_round_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_fl_round(build_model(_cfg()), _cfg(), (4,))


def _round_inputs(C=4, batch=16, seed=0):
    model = build_model(_cfg(C=C, batch=batch))
    params = torch.cat([v.reshape(-1) for _, v in sorted(
        model.init(1, device="cpu").items())])
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, 28, 28, 1))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, batch))
    return model, params, {"images": images, "labels": labels}


def test_quantized_modes_give_equal_params_from_one_generator():
    """From the same generator, int, packed, both rings and auto give the
    same new parameters to the last bit, and report the plan's wire bits."""
    model, params, batch = _round_inputs()
    want_bits = {"paper": 32.0, "int": 16.0, "packed": 32.0 / 3,
                 "ring": 24.0, "auto": 32.0 / 3}
    out = {}
    for mode, hops in (("paper", True), ("int", True), ("packed", True),
                       ("ring", True), ("ring", False), ("auto", True)):
        cfg = _cfg(pipeline_hops=hops)
        fn = make_fl_round(model, cfg, (4,), collective=mode, device="cpu")
        new, m = fn(params, batch, torch.Generator().manual_seed(3))
        assert new.shape == params.shape and bool(torch.isfinite(new).all())
        assert np.isfinite(float(m["loss"]))
        assert m["wire_bits_per_param"] == want_bits[mode]
        assert sum(m["wire_phase_bits_per_param"].values()) == want_bits[mode]
        out[(mode, hops)] = new
    for key in (("packed", True), ("ring", True), ("ring", False),
                ("auto", True)):
        assert torch.equal(out[key], out[("int", True)]), key
    assert not torch.equal(out[("paper", True)], params)


def test_cohort_batches_split_rows_and_drop_the_remainder():
    """Cohort c trains on rows [c·b, (c+1)·b) of the global batch in I
    microbatches; the b mod I rows left over do not move the round."""
    C, I, batch = 2, 3, 14                  # b = 7: microbatches of 2, 1 left
    model, params, data = _round_inputs(C=C, batch=batch)
    fn = make_fl_round(model, _cfg(C=C, I=I, batch=batch, q=0.0), (C,),
                       collective="int", device="cpu")
    base, _ = fn(params, data, torch.Generator().manual_seed(0))
    for row, moves in ((6, False), (13, False), (5, True), (7, True)):
        changed = {k: v.clone() for k, v in data.items()}
        changed["images"][row] = 1.0 - changed["images"][row]
        new, _ = fn(params, changed, torch.Generator().manual_seed(0))
        assert torch.equal(new, base) != moves, row
    with pytest.raises(ValueError, match="split"):
        fn(params, {k: v[:13] for k, v in data.items()},
           torch.Generator().manual_seed(0))


_JAX_ROUND = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import channel as ch
from repro.core.fl import make_fl_round
from repro.models import build_model
from repro.utils.compat import make_mesh, set_mesh

C, I, B, Q, SEED = 4, 2, 32, 0.3, 5
cfg = get_config("mnist_cnn")
cfg = dataclasses.replace(
    cfg, channel=dataclasses.replace(cfg.channel, error_prob=Q),
    fl=dataclasses.replace(cfg.fl, local_iters=I, learning_rate=0.05),
    train=dataclasses.replace(cfg.train, global_batch=B))
mesh = make_mesh((C,), ("data",))
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(1))
names = sorted(params)
data = np.random.default_rng(0)
batch = {"images": data.uniform(0, 1, (B, 28, 28, 1)).astype(np.float32),
         "labels": data.integers(0, 10, B).astype(np.int32)}
rng = jax.random.PRNGKey(SEED)
flat = lambda p: np.concatenate([np.asarray(p[k]).ravel() for k in names])
out = {"params": flat(params), **batch}
with set_mesh(mesh):
    for mode in ("paper", "int", "packed", "ring", "auto"):
        fn = jax.jit(make_fl_round(model, cfg, mesh, collective=mode))
        new, m = fn(params, batch, rng)
        out[mode + "/params"] = flat(new)
        for k in ("loss", "survivors", "wire_bits_per_param"):
            out[mode + "/" + k] = np.float32(m[k])

def leaf_noise(key):      # split(key, n_leaves), one uniform draw per leaf
    keys = jax.random.split(key, len(names))
    return np.concatenate([np.asarray(jax.random.uniform(
        k, params[n].shape, jnp.float32)).ravel() for k, n in zip(keys, names)])

u_train, u_up, lam = [], [], []
for c in range(C):        # the round's key chain, fl.py:630-633 and :591-602
    rc = jax.random.fold_in(rng, c)
    lam.append(float(ch.sample_packet_success(jax.random.fold_in(rc, 11), (), Q)))
    u_train.append([leaf_noise(k) for k in jax.random.split(rc, I)])
    u_up.append(leaf_noise(jax.random.fold_in(rc, 13)))
np.savez(sys.argv[1], u_train=np.array(u_train), u_up=np.array(u_up),
         lam=np.array(lam, np.float32), **out)
"""


def test_cohort_round_matches_the_real_make_fl_round(tmp_path):
    """The real JAX round on a (4,) "data" host mesh at the QNN's full
    width (global batch 32, I=2, q=0.3: two of four cohorts dropped on this
    key) against the port's round on the CPU with the reference's draws.
    Parameters within 1e-6 (they come out bit-exact: the uplink codes are
    equal); loss within rtol 1e-5 (the local steps' float sums run in
    another order); survivors and wire bits equal."""
    path = tmp_path / "round.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_ROUND),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    z = np.load(path)
    assert 0 < z["lam"].sum() < 4
    cfg = _cfg(C=4, I=2, batch=32, q=0.3)
    model = build_model(cfg)
    params = torch.from_numpy(z["params"])
    batch = {"images": torch.from_numpy(z["images"]),
             "labels": torch.from_numpy(z["labels"])}
    noise = RoundNoise(*(torch.from_numpy(z[k])
                         for k in ("u_train", "u_up", "lam")))
    for mode in ("paper", "int", "packed", "ring", "auto"):
        fn = make_fl_round(model, cfg, (4,), collective=mode, device="cpu")
        new, m = fn(params, batch, noise=noise)
        np.testing.assert_allclose(new.numpy(), z[mode + "/params"], rtol=0,
                                   atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(float(m["loss"]), z[mode + "/loss"],
                                   rtol=1e-5, err_msg=mode)
        assert float(m["survivors"]) == z[mode + "/survivors"], mode
        assert np.float32(m["wire_bits_per_param"]) == \
            z[mode + "/wire_bits_per_param"], mode
