"""The port's optimizers (``repro_torch.optim``) against ``repro.optim``.

On the quadratic of ``tests/test_fl_system.py``'s
``test_sgd_and_adam_converge_quadratic``, both packages take the same
gradients (the reference's ``jax.grad`` at its own parameters) for 200
steps; the port's parameters, state and schedules must equal the
reference's bit for bit at every step.  Both run eagerly, one rounding an
operation; Adam's bias corrections are ``pow`` of float32 scalars on both
sides, and measured equal too (JAX 0.9.0, torch 2.13, the CPU), so no
tolerance is needed.  Adam's square root is the correctly rounded one, as
XLA's: PyTorch's float32 ``sqrt`` on the CPU differs from it at 624 of
10^5 values (``test_adam_square_root_is_correctly_rounded``).

The cosine schedule's ``cos`` is correctly rounded on neither side: the
port takes it in float64 and rounds once, and is held equal at steps 0,
10 and 100 (and 5, 55, 250) and within one float32 ulp at every
step 0-250, where it was measured to differ at one step (62) of 251.  The
optimizers' steps are held bit for bit under the warm-up schedule, which
is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jo
from repro_torch.optim import optimizers as to

TARGET = np.asarray([1.0, -2.0, 3.0], np.float32)

OPTS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "adam": lambda m: m.adam(0.1),
    "adamw": lambda m: m.adamw(0.1),
    "sgd_warmup": lambda m: m.sgd(m.linear_warmup(0.1, 7), momentum=0.9),
    "adam_warmup": lambda m: m.adam(m.linear_warmup(0.1, 7)),
    "make_sgd_momentum": lambda m: m.make_optimizer("sgd", 0.1, momentum=0.5),
    "make_adamw": lambda m: m.make_optimizer("adamw", 0.05,
                                             weight_decay=0.1),
}


def _equal(t, j):
    if isinstance(t, dict):
        return set(t) == set(j) and all(_equal(t[k], j[k]) for k in t)
    a = np.asarray(j)
    return (t.shape == a.shape and str(t.dtype).split(".")[-1] == str(a.dtype)
            and np.array_equal(t.float().numpy(), a.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_steps_equal_the_references(name, dtype):
    target = jnp.asarray(TARGET, dtype)
    loss = lambda p: jnp.sum((p["x"]["y"] - target) ** 2)
    jopt, topt = OPTS[name](jo), OPTS[name](to)
    jp = {"x": {"y": jnp.zeros(3, dtype)}}
    tp = {"x": {"y": torch.zeros(3, dtype=getattr(torch, dtype))}}
    js, ts = jopt.init(jp), topt.init(tp)
    assert _equal(ts, js)
    for i in range(200):
        g = jax.grad(loss)(jp)
        ju, js = jopt.update(g, js, jp)
        jp = jo.apply_updates(jp, ju)
        tg = {"x": {"y": torch.from_numpy(np.array(g["x"]["y"], np.float32))
                    .to(getattr(torch, dtype))}}
        tu, ts = topt.update(tg, ts, tp)
        tp = to.apply_updates(tp, tu)
        assert _equal(tu, ju) and _equal(ts, js) and _equal(tp, jp), (name, i)
    if dtype == "float32" and name in ("sgd", "sgd_momentum", "adam"):
        np.testing.assert_allclose(tp["x"]["y"].numpy(), TARGET, atol=1e-2)


@pytest.mark.parametrize("step", [0, 10, 100, 5, 55, 250])
def test_schedules_equal_the_references(step):
    for j, t in ((jo.cosine_schedule(1.0, 10, 100),
                  to.cosine_schedule(1.0, 10, 100)),
                 (jo.cosine_schedule(0.3, 0, 40, min_frac=0.0),
                  to.cosine_schedule(0.3, 0, 40, min_frac=0.0)),
                 (jo.linear_warmup(0.5, 10), to.linear_warmup(0.5, 10))):
        want = j(jnp.asarray(step, jnp.int32))
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(want), step


def test_make_optimizer_names():
    assert isinstance(to.make_optimizer("adam", 0.1), to.Optimizer)
    with pytest.raises(ValueError):
        to.make_optimizer("lion", 0.1)
    state = to.sgd(0.1).init({"w": torch.zeros(2)})
    assert state["step"].dtype == torch.int32 and "mu" not in state


def test_adam_square_root_is_correctly_rounded():
    """``optimizers._sqrt`` against float64's square root rounded once, and
    against ``jnp.sqrt``, on 10^5 float32 values."""
    rng = np.random.default_rng(0)
    v = np.abs(rng.standard_normal(100_000)).astype(np.float32) * 0.01
    exact = np.sqrt(v.astype(np.float64)).astype(np.float32)
    got = to._sqrt(torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, exact)
    assert np.array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(v))))


def test_cosine_schedule_within_an_ulp_at_every_step():
    for args in ((1.0, 10, 100), (0.1, 10, 100), (0.3, 0, 40, 0.0)):
        j, t = jo.cosine_schedule(*args), to.cosine_schedule(*args)
        ulps = []
        for step in range(251):
            a = np.float32(j(jnp.asarray(step, jnp.int32)))
            b = t(torch.tensor(step, dtype=torch.int32)).numpy()
            ulps.append(abs(int(a.view(np.int32)) - int(b.view(np.int32))))
        assert max(ulps) <= 1 and sum(u > 0 for u in ulps) <= 2, (args, ulps)
