"""The wire formats of the port's cohort round
(``repro_torch.core.aggregation.aggregate``) against the reference; the
round itself is held in ``tests/test_torch_cohort_round_runs.py``.

The reference's collective runs one cohort per mesh shard.  Its own
``agg.aggregate`` runs unchanged under ``jax.vmap(..., axis_name="data")``
on one CPU device — ``psum``, ``ppermute`` and ``axis_index`` batch under
``vmap`` — which is the cohort-stacked form the port computes; the port is
fed the reference's rounding noise (``aggregation._flat_noise`` of each
cohort's key).
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch

from repro_torch.config.base import QuantConfig
from repro_torch.core import aggregation as tagg

LEAVES = {"a": (1003,), "b": (3, 17)}     # a two-leaf delta, 1,054 values
D = sum(int(np.prod(s)) for s in LEAVES.values())


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
