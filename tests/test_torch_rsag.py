"""The port's rsag reducer and its ring over more than one cohort axis
(``repro_torch.core.aggregation``) against the reference; their rounds
are held in ``tests/test_torch_rsag_runs.py``.

The reference's own ``agg.aggregate`` runs under nested ``jax.vmap`` — one
named axis per cohort axis, "pod" outside "data" — on one CPU device, which
is the cohort-stacked form the port computes: row c = p·K_data + d.  The
port is fed the reference's rounding noise.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.config.base import QuantConfig
from repro_torch.core import aggregation as tagg

LEAVES = {"a": (1003,), "b": (3, 17)}     # a two-leaf delta, 1,054 values
D = sum(int(np.prod(s)) for s in LEAVES.values())
LAYOUTS = [(4,), (5,), (2, 2), (2, 3), (3, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run the QNN's rounds and many small CPU ops; under the
    suite's parallel workers a thread pool per op only contends for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
