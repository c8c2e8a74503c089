"""The port's cohort round (``repro_torch.core.fl.make_fl_round``) against
the reference: the rounds of every wire format from one generator, the
batch's split over the cohorts, and the whole round held to the real
``make_fl_round`` on a 4-device host mesh in a subprocess, on the
reference's own key-chain draws.  The wire formats alone are held in
``tests/test_torch_cohort_round.py``; this file is apart from it so that
each holds fewer tests than ``tests/test_distributed.py``, which the
suite's ``--dist loadfile`` workers then take up first.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config.base import QuantConfig
from repro_torch.configs import get_config
from repro_torch.core import aggregation as tagg
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.models import build_model
from test_torch_cohort_round import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
