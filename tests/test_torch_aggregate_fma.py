"""The port's eq. 6 aggregation in the reference's order of operations.

XLA:CPU contracts the multiply of ``sum(u * w, axis=0)`` into its reduce,
so the Pallas kernel ``repro.kernels.aggregate.masked_aggregate`` (in
interpret mode), ``repro.kernels.ref.masked_aggregate_ref`` and the jitted
``repro.core.aggregation.error_aware_aggregate`` compute the chain
``acc = fma(w_k, u_k, acc)`` for k = 0..K-1 from 0, over the weights'
sum taken in k order.  The port's plain version
(``repro_torch.kernels.ref.masked_aggregate_ref``, an exact float32 FMA
``fma32``) runs the same chain and is held to them bit for bit here; the
CUDA kernel is held ``torch.equal`` to the plain version by the ``gpu``
tests of ``tests/test_torch_kernels.py`` and by ``chip_smoke.py``.

Every assertion message says whether XLA:CPU contracted a probe
``jit(lambda a, b, c: a * b + c)`` on this machine: where it does not,
the reference rounds twice and the equalities fail for that reason.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels import ref as jref
from repro.kernels.aggregate import masked_aggregate as pallas_aggregate
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

MAIN = (10, 421_642)


@pytest.fixture(scope="module")
def contracted():
    """Why an equality may fail: whether XLA:CPU fused a probe multiply-add
    (the product (1 + 2^-23)(1 - 2^-23) rounds to 1 alone, so only a fused
    multiply-add leaves -2^-46 after adding -1)."""
    a, b = np.float32(1 + 2 ** -23), np.float32(1 - 2 ** -23)
    got = float(jax.jit(lambda a, b, c: a * b + c)(a, b, np.float32(-1)))
    fused = got == -2.0 ** -46
    return (f"XLA:CPU {'contracted' if fused else 'did NOT contract'} the "
            f"probe jit(lambda a, b, c: a * b + c) (got {got!r})")


def _inputs(K, D, dtype, seed, zero_weights=False):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        upd = rng.normal(0.0, 0.01, (K, D)).astype(np.float32)
    else:
        upd = rng.integers(-128, 128, (K, D)).astype(np.int32)
    w = (rng.uniform(0.01, 0.2, K) * (rng.uniform(size=K) > 0.3)).astype(np.float32)
    w[0] = 0.1
    if K > 1:
        w[-1] = 0.0
    if zero_weights:
        w[:] = 0.0
    return upd, w


def _held(upd, w, why):
    want = np.asarray(pallas_aggregate(jnp.asarray(upd), jnp.asarray(w),
                                       interpret=True))
    oracle = np.asarray(jref.masked_aggregate_ref(jnp.asarray(upd), jnp.asarray(w)))
    got = ops.masked_aggregate(torch.from_numpy(upd), torch.from_numpy(w)).numpy()
    assert got.shape == (upd.shape[1],) and got.dtype == np.float32, why
    np.testing.assert_array_equal(got, want, err_msg=f"against Pallas; {why}")
    np.testing.assert_array_equal(got, oracle, err_msg=f"against the oracle; {why}")
    return got


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("D", [7, 4099, 5003])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 10, 13, 16, 17])
def test_plain_bit_exact_with_pallas_and_oracle(contracted, K, D, dtype):
    upd, w = _inputs(K, D, dtype, seed=K * 10_000 + D)
    _held(upd, w, f"K={K} D={D} {dtype}; {contracted}")


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_all_zero_weights_bit_exact_and_zero(contracted, dtype):
    upd, w = _inputs(4, 300, dtype, seed=5, zero_weights=True)
    got = _held(upd, w, f"all-zero weights {dtype}; {contracted}")
    np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_plain_bit_exact_at_the_main_shape(contracted, dtype):
    upd, w = _inputs(*MAIN, dtype, seed=42)
    _held(upd, w, f"{MAIN} {dtype}; {contracted}")


def test_error_aware_aggregate_bit_exact_with_jitted_reference(contracted):
    K, D = MAIN
    rng = np.random.default_rng(7)
    w = rng.normal(size=D).astype(np.float32)
    deltas = rng.normal(0.0, 0.01, (K, D)).astype(np.float32)
    alphas = rng.uniform(0.05, 0.15, K).astype(np.float32)
    lam = (rng.uniform(size=K) > 0.2).astype(np.float32)
    lam[0] = 0.0
    want = jax.jit(jagg.error_aware_aggregate)(
        {"w": jnp.asarray(w)}, {"w": jnp.asarray(deltas)}, jnp.asarray(alphas),
        jnp.asarray(lam))["w"]
    got = tagg.error_aware_aggregate(torch.from_numpy(w), torch.from_numpy(deltas),
                                     torch.from_numpy(alphas), torch.from_numpy(lam))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=f"error_aware_aggregate; {contracted}")


def _f32(x) -> np.float32:
    return np.float32(x)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the rational q, ties to an even last bit."""
    guess = np.float32(float(q))          # within one float32 step of it
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def _triples(kind, rng, n=100):
    """n float32 triples (a, b, c) of one adversarial kind."""
    out = []
    for _ in range(n):
        s = rng.choice([-1.0, 1.0], 3)
        if kind == "midpoint":
            # a·b a float32 midpoint (1 + m·2^-12 squared reaches 2^-24),
            # c zero, far below it, or one step that moves it off
            a = s[0] * (1 + rng.integers(1, 64) * 2.0 ** -12)
            b = s[1] * (1 + rng.integers(1, 64) * 2.0 ** -12)
            scale = 2.0 ** int(rng.integers(-20, 20))
            c = s[2] * rng.choice([0.0, 2.0 ** -80, 2.0 ** -50, 2.0 ** -24,
                                   3 * 2.0 ** -25]) * scale
            a = a * scale
        elif kind == "cancellation":
            # c = -RN(a·b): the result is the product's rounding error
            a = s[0] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-30, 30))
            b = s[1] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-30, 30))
            c = -float(_f32(a) * _f32(b))
        elif kind == "subnormal":
            # products and sums near and below 2^-126
            a = s[0] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-80, -60))
            b = s[1] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-80, -60))
            c = s[2] * rng.integers(0, 2 ** 23) * 2.0 ** -149
        else:
            a = s[0] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-20, 20))
            b = s[1] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-20, 20))
            c = s[2] * rng.uniform(0.5, 2.0) * 2.0 ** int(rng.integers(-40, 40))
        out.append((_f32(a), _f32(b), _f32(c)))
    return out


@pytest.mark.parametrize("kind", ["midpoint", "cancellation", "subnormal",
                                  "random"])
def test_fma32_is_the_correctly_rounded_fused_multiply_add(contracted, kind):
    triples = _triples(kind, np.random.default_rng(["midpoint", "cancellation",
                                                     "subnormal", "random"].index(kind)))
    a, b, c = (np.array(t, np.float32) for t in zip(*triples))
    got = tref.fma32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z))) for x, y, z in triples],
                    np.float32)
    np.testing.assert_array_equal(got, want, err_msg=f"{kind}; {contracted}")
    if kind == "midpoint":
        # the cases that rounding the float64 sum to nearest would get wrong
        naive = (a.astype(np.float64) * b + c).astype(np.float32)
        assert (naive != want).any(), "no case needs the round to odd"
