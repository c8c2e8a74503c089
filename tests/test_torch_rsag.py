"""The port's rsag reducer and its ring over more than one cohort axis
(``repro_torch.core.aggregation``) against the reference.

The reference's own ``agg.aggregate`` runs under nested ``jax.vmap`` — one
named axis per cohort axis, "pod" outside "data" — on one CPU device, which
is the cohort-stacked form the port computes: row c = p·K_data + d.  The
port is fed the reference's rounding noise.  The whole round is held to the
real ``make_fl_round`` on a (2, 2) ("pod", "data") host mesh in a
subprocess, on the reference's own key-chain draws.
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
LAYOUTS = [(4,), (5,), (2, 2), (2, 3), (3, 2)]


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.config.base import QuantConfig as JQuantConfig
    from repro.core import aggregation as agg
    return types.SimpleNamespace(jax=jax, jnp=jnp, agg=agg,
                                 QuantConfig=JQuantConfig)


def _axes(sizes):
    return ("pod", "data")[-len(sizes):]


def _reference(jx, mode, qcfg, sizes):
    """The reference's ``aggregate`` over the cohort grid ``sizes``, one
    ``vmap`` per axis: (delta tree with sizes + leaf-shape leaves, lam
    ``sizes``, keys sizes + (2,)) -> (every cohort's aggregated delta
    (C, D), the uplink noise (C, D)), rows in row-major cohort order."""
    jax, jnp = jx.jax, jx.jnp
    C = int(np.prod(sizes))
    plan = jx.agg.make_wire_plan(mode, qcfg, _axes(sizes), sizes)

    def one(delta, lam, key):
        out = jx.agg.aggregate(plan, delta, jnp.float32(1.0 / C), lam, key)
        leaves = jax.tree_util.tree_leaves(delta)
        u = jx.agg._flat_noise(leaves, jax.random.split(key, len(leaves)))
        return jnp.concatenate([out[k].ravel() for k in sorted(out)]), u

    fn = one
    for axis in reversed(_axes(sizes)):
        fn = jax.vmap(fn, axis_name=axis)
    fn = jax.jit(fn)

    def run(delta, lam, keys):
        out, u = fn({k: jnp.asarray(v) for k, v in delta.items()},
                    jnp.asarray(lam.reshape(sizes)), keys)
        return np.asarray(out).reshape(C, -1), np.array(u).reshape(C, -1)

    return run


def _inputs(jx, sizes, seed, scale=0.3):
    """Deltas of every cohort, their keys and λ with two cohorts dropped."""
    C = int(np.prod(sizes))
    rng = np.random.default_rng(seed)
    delta = {k: rng.normal(0.0, scale, tuple(sizes) + s).astype(np.float32)
             for k, s in LEAVES.items()}
    flat = np.concatenate([delta[k].reshape(C, -1) for k in sorted(delta)], 1)
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(seed), C)
    keys = keys.reshape(tuple(sizes) + (2,))
    lam = np.ones(C, np.float32)
    lam[[1, C - 1]] = 0.0
    return delta, flat, keys, lam


def _port(mode, qcfg, sizes, flat, lam, u):
    plan = tagg.make_wire_plan(mode, qcfg, _axes(sizes), sizes)
    return tagg.aggregate(plan, torch.from_numpy(flat), 1.0 / plan.num_shards,
                          torch.from_numpy(lam), torch.tensor(u))


@pytest.mark.parametrize("mode", ["ring", "rsag"])
@pytest.mark.parametrize("sizes", LAYOUTS, ids=str)
def test_aggregate_bit_exact_with_reference_at_clip_1(jx, sizes, mode):
    """At clip 1 the port's rsag and ring, under either ``pipeline_hops``
    front-end, equal the reference's to the last bit in every cohort row,
    with the reference on its pure path and through its Pallas kernels
    (interpret mode) with the pipelined schedule; on the two-axis grids
    also the Pallas path with the sequential schedule.  Both equal the
    port's int and packed."""
    delta, flat, keys, lam = _inputs(jx, sizes, seed=sum(sizes))
    refs = [(False, True), (True, True)]
    if len(sizes) == 2:
        refs.append((True, False))
    port = {}
    for use_pallas, hops in refs:
        q = jx.QuantConfig(bits=8, use_pallas=use_pallas, pipeline_hops=hops)
        want, u = _reference(jx, mode, q, sizes)(delta, lam, keys)
        for port_hops in (True, False):
            if port_hops not in port:
                port[port_hops] = _port(mode, QuantConfig(
                    bits=8, pipeline_hops=port_hops), sizes, flat, lam, u)
            got = port[port_hops]
            assert got.shape == (D,) and got.dtype == torch.float32
            for c in range(want.shape[0]):
                np.testing.assert_array_equal(
                    got.numpy(), want[c],
                    err_msg=f"{mode} {sizes} pallas={use_pallas} hops={hops} "
                            f"port hops={port_hops} cohort {c}")
    for other in ("int", "packed"):
        assert torch.equal(_port(other, QuantConfig(bits=8), sizes, flat, lam,
                                 u), port[True]), other


@pytest.mark.parametrize("sizes", LAYOUTS, ids=str)
def test_aggregate_at_clip_0_3_modes_equal_and_within_2_ulp(jx, sizes):
    """At clip 0.3 the reference's pure path dequantizes by a divide and
    the port by a multiply (ROADMAP C), so rsag and ring are held within
    2 ulp of the reference's; the port's int, packed, ring and rsag, both
    front-ends, stay ``torch.equal``."""
    delta, flat, keys, lam = _inputs(jx, sizes, seed=20 + sum(sizes),
                                     scale=0.1)
    got = {}
    for mode in ("ring", "rsag"):
        want, u = _reference(jx, mode, jx.QuantConfig(bits=8, clip=0.3),
                             sizes)(delta, lam, keys)
        for hops in (True, False):
            got[mode, hops] = _port(mode, QuantConfig(
                bits=8, clip=0.3, pipeline_hops=hops), sizes, flat, lam, u)
            assert np.all(np.abs(got[mode, hops].numpy() - want[0])
                          <= 2 * np.spacing(np.abs(want[0]))), (mode, hops)
    base = _port("int", QuantConfig(bits=8, clip=0.3), sizes, flat, lam, u)
    got["packed", True] = _port("packed", QuantConfig(bits=8, clip=0.3),
                                sizes, flat, lam, u)
    for key, value in got.items():
        assert torch.equal(value, base), key


@pytest.mark.parametrize("hops", [True, False])
@pytest.mark.parametrize("sizes", [(5,), (2, 3), (3, 2), (2, 5)], ids=str)
def test_every_row_holds_the_sum_and_the_plan_counts_launches(sizes, hops,
                                                              monkeypatch):
    """Every cohort row of the ring's stacked result, and the one row that
    rsag's last gather moves (row 0, what the aggregate reads), holds the
    same sum, and each wrapper is called as often as the reference's
    schedule launches its kernel: per axis of K entries the ring takes
    K - 1 repacks and, after the first axis, one pack_sums; rsag takes
    K - 1 repacks, K pack_sums (K - 1 on the first axis under
    ``pipeline_hops``, whose quantize_pack_chunk packs hop 1) and one
    unpack, into int32 codes before the last axis."""
    from repro_torch.kernels import ops
    calls = {}
    for name in ("quantize_pack_chunk", "quantize_pack",
                 "stochastic_quantize_codes", "repack", "pack_sums",
                 "unpack_dequantize"):
        def counted(*a, _fn=getattr(ops, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    C, n = int(np.prod(sizes)), 301
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 0.2, (C, n)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1, (C, n)).astype(np.float32))
    q = QuantConfig(bits=8, pipeline_hops=hops)
    codes = torch.floor(torch.clamp(x, -1, 1) * 128 + u).clamp(-128, 127)
    want = codes.sum(0) / 128
    axes, ks = _axes(sizes), [k for k in sizes if k > 1]
    front = ({"quantize_pack_chunk": 1} if hops else
             {"quantize_pack": 1})
    expected = {
        "ring": {**front, "repack": sum(k - 1 for k in ks) + (not hops),
                 "pack_sums": len(ks) - 1},
        "rsag": {("quantize_pack_chunk" if hops else
                  "stochastic_quantize_codes"): 1,
                 "repack": sum(k - 1 for k in ks) + len(ks) - 1,
                 "pack_sums": sum(ks) - hops, "unpack_dequantize": 1}}
    for mode, summed in (("ring", tagg.ring_sum), ("rsag", tagg.rsag_sum)):
        calls.clear()
        out = summed(tagg.make_wire_plan(mode, q, axes, sizes), x, u)
        assert calls == {k: v for k, v in expected[mode].items() if v}, mode
        assert out.shape == ((C, n) if mode == "ring" else (1, n)), mode
        for r in range(out.shape[0]):
            got = out[r].float() / 128 if mode == "ring" else out[r]
            assert torch.equal(got, want), (mode, r)


def _cfg(I=2, batch=32, q=0.3, **quant):
    cfg = get_config("mnist_cnn")
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, **quant),
        channel=dataclasses.replace(cfg.channel, error_prob=q),
        fl=dataclasses.replace(cfg.fl, local_iters=I, learning_rate=0.05),
        train=dataclasses.replace(cfg.train, global_batch=batch))


def test_two_axis_rounds_give_equal_params_and_the_plan_bits():
    """At (2, 5) ("pod", "data") from one generator, int, packed, both
    rings, both rsag front-ends and auto (which resolves to packed there)
    give the same new parameters to the last bit; rsag at (10,) gives
    those of int at (10,).  Wire bits as the plan prices them."""
    model = build_model(_cfg())
    params = torch.cat([v.reshape(-1) for _, v in sorted(
        model.init(1, device="cpu").items())])
    rng = np.random.default_rng(0)
    B = 40
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (B, 28, 28, 1))
                                        .astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, B))}
    want_bits = {(2, 5): {"int": 16.0, "packed": 16.0, "ring": 152.0 / 3,
                          "rsag": 32.8, "auto": 16.0},
                 (10,): {"int": 16.0, "rsag": 26.4}}
    for sizes, bits in want_bits.items():
        out = {}
        for mode, hops in itertools.product(bits, (True, False)):
            if hops is False and mode not in ("ring", "rsag"):
                continue
            fn = make_fl_round(model, _cfg(batch=B, pipeline_hops=hops),
                               sizes, collective=mode, device="cpu")
            new, m = fn(params, batch, torch.Generator().manual_seed(3))
            assert bool(torch.isfinite(new).all())
            assert m["wire_bits_per_param"] == pytest.approx(bits[mode],
                                                             rel=1e-12)
            out[mode, hops] = new
        for key, value in out.items():
            assert torch.equal(value, out["int", True]), (sizes, key)
        assert not torch.equal(out["int", True], params)


_JAX_ROUND = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core import channel as ch
from repro.core.fl import make_fl_round
from repro.models import build_model
from repro.utils.compat import make_mesh, set_mesh

P, K, I, B, Q, SEED = 2, 2, 2, 32, 0.3, 5
cfg = get_config("mnist_cnn")
cfg = dataclasses.replace(
    cfg, channel=dataclasses.replace(cfg.channel, error_prob=Q),
    fl=dataclasses.replace(cfg.fl, local_iters=I, learning_rate=0.05),
    train=dataclasses.replace(cfg.train, global_batch=B))
mesh = make_mesh((P, K), ("pod", "data"))
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
    for mode in ("rsag", "ring"):
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
for p in range(P):        # the round's key chain: pod, then data folded in
    for d in range(K):
        rc = jax.random.fold_in(jax.random.fold_in(rng, p), d)
        lam.append(float(ch.sample_packet_success(jax.random.fold_in(rc, 11),
                                                  (), Q)))
        u_train.append([leaf_noise(k) for k in jax.random.split(rc, I)])
        u_up.append(leaf_noise(jax.random.fold_in(rc, 13)))
np.savez(sys.argv[1], u_train=np.array(u_train), u_up=np.array(u_up),
         lam=np.array(lam, np.float32), **out)
"""


def test_two_axis_round_matches_the_real_make_fl_round(tmp_path):
    """The real JAX round on a (2, 2) ("pod", "data") host mesh at the
    QNN's full width (global batch 32, I=2, q=0.3) in rsag and ring,
    against the port's round at axis_sizes (2, 2) on the CPU with the
    reference's draws.  Parameters within 1e-6; loss within rtol 1e-5 (the
    local steps' float sums run in another order); survivors and wire bits
    equal."""
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
    cfg = _cfg(I=2, batch=32, q=0.3)
    model = build_model(cfg)
    params = torch.from_numpy(z["params"])
    batch = {"images": torch.from_numpy(z["images"]),
             "labels": torch.from_numpy(z["labels"])}
    noise = RoundNoise(*(torch.from_numpy(z[k])
                         for k in ("u_train", "u_up", "lam")))
    for mode in ("rsag", "ring"):
        fn = make_fl_round(model, cfg, (2, 2), collective=mode, device="cpu")
        new, m = fn(params, batch, noise=noise)
        np.testing.assert_allclose(new.numpy(), z[mode + "/params"], rtol=0,
                                   atol=1e-6, err_msg=mode)
        np.testing.assert_allclose(float(m["loss"]), z[mode + "/loss"],
                                   rtol=1e-5, err_msg=mode)
        assert float(m["survivors"]) == z[mode + "/survivors"], mode
        assert np.float32(m["wire_bits_per_param"]) == \
            z[mode + "/wire_bits_per_param"], mode
