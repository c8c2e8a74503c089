"""The float32 local step rounds once, as the reference's does (ROADMAP C5).

The reference's step is ``w - eta * g.astype(w.dtype)``.  Inside a jitted
computation whose gradient is computed there (``jax.lax.scan`` over the
local steps, or the standard step's ``value_and_grad``), XLA:CPU contracts
the multiply and the subtraction into one fused multiply-add, so the new
weight is the correctly rounded w - eta*g.  (With g a constant closed
over, XLA folds eta*g first and rounds twice: the references below compute
their gradient inside, as the round does.)  The port's step is
``kernels.ops.fma_step_``: ``fma32`` on the CPU, ``csrc/sgd.cu`` on the
card.  On ROADMAP C5's input (200,000 weights N(0, 0.05²), gradients
N(0, 1), ``default_rng(0)``, eta 0.001) a mul and a sub differ from the
reference at 6,028 weights; the port must differ at none, at each of the
three sites: the simulator's local steps (``FLSimulator._client_update``,
the real one), the cohort round's (``make_fl_round``'s ``_cohort_update``
scan, rebuilt here as the round builds it) and the standard step
(``launch.steps.make_standard_train_step``, the real one).  bfloat16 keeps
its product and difference, already the reference's bit for bit.

The JAX reference is imported by a fixture, so the ``gpu`` test runs where
JAX is not installed (``pytest -m gpu --noconftest``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import fl as tfl
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps

D, ETA = 200_000, 0.001
SHAPES = {"a": (500, 160), "b": (120_000,)}   # 80,000 + 120,000 = D


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.core.fl import FLSimulator
    from repro.launch.steps import make_standard_train_step
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jget_config,
                                 FLSimulator=FLSimulator,
                                 standard_step=make_standard_train_step)


def _roadmap_input(rows=1):
    """C5's weights and ``rows`` gradient vectors, the first ROADMAP's."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(D) * 0.05).astype(np.float32)
    g = np.stack([rng.standard_normal(D).astype(np.float32)
                  for _ in range(rows)])
    return w, g


def _exact(w, g):
    return tref.fma32(torch.tensor(-np.float32(ETA)), torch.from_numpy(g),
                      torch.from_numpy(w)).numpy()


def _cfg():
    cfg = get_config("mnist_cnn")
    return dataclasses.replace(
        cfg, fl=dataclasses.replace(cfg.fl, learning_rate=ETA, local_iters=1))


class _LinearModel:
    """A model whose loss is Σ w·g: its gradient is g exactly, so a step's
    only rounding is the update's.  ``quantizes_training`` picks the
    port's QNN path (the STE fake-quant, identity inside the clip)."""
    dtype = torch.float32

    def __init__(self, quantizes_training):
        self.quantizes_training = quantizes_training
        self.param_shapes = convert.Layout.uniform(SHAPES, torch.float32)

    @staticmethod
    def _dot(leaves, g):
        flat = torch.cat([leaves[k].reshape(*leaves[k].shape[:g.dim() - 1], -1)
                          for k in sorted(leaves)], dim=-1)
        return (flat * g).sum(-1)

    def loss_stacked(self, leaves, batch):
        ce = self._dot(leaves, batch["g"])
        return ce, torch.zeros_like(ce)

    def loss(self, leaves, batch, u=None):
        return self._dot(leaves, batch["g"]), {}


def _port_local(w, g, quantizes_training):
    """The port's local step for K = len(g) clients, I = 1."""
    K = g.shape[0]
    batches = {"labels": torch.zeros(K, 1, 1),
               "g": torch.from_numpy(g)[:, None]}
    u = torch.zeros(K, 1, D) if quantizes_training else None
    p, _, _ = tfl.local_sgd(_LinearModel(quantizes_training), _cfg(),
                            torch.from_numpy(w), batches, u_train=u)
    return p.numpy()


def test_plain_step_differs_from_two_roundings_on_roadmap_input():
    """The input shows C5: two roundings differ from the exact step at
    6,028 weights; ``ops.fma_step_`` on the CPU is ``fma32`` in place."""
    w, g = _roadmap_input()
    exact = _exact(w, g[0])
    two = (torch.from_numpy(w) - float(np.float32(ETA))
           * torch.from_numpy(g[0])).numpy()
    assert int((two != exact).sum()) == 6028
    got = torch.from_numpy(w.copy())
    assert ops.fma_step_(got, torch.from_numpy(g[0]), float(np.float32(ETA))) is got
    assert np.array_equal(got.numpy(), exact)


def test_simulator_site_matches_the_reference(jx):
    """``FLSimulator._client_update`` (jitted; its scan computes the
    gradient in the body) against the port's QNN path of ``local_sgd``:
    the delta p - w is a function of p, so equal deltas mean equal steps."""
    jax, jnp = jx.jax, jx.jnp
    w, g = _roadmap_input()
    jcfg = jx.get_config("mnist_cnn")
    jcfg = dataclasses.replace(
        jcfg, fl=dataclasses.replace(jcfg.fl, learning_rate=ETA,
                                     local_iters=1),
        quant=dataclasses.replace(jcfg.quant, quantize_uplink=False))

    class JModel:
        def loss(self, p, batch, key):
            return jnp.sum(p["w"] * batch["g"]), {}

    sim = object.__new__(jx.FLSimulator)
    sim.config, sim.model = jcfg, JModel()
    delta, _, _ = jax.jit(sim._client_update)(
        {"w": jnp.asarray(w)}, {"g": jnp.asarray(g)}, jax.random.PRNGKey(0))
    p = _port_local(w, g, quantizes_training=True)
    assert p.shape == (1, D)
    want = np.asarray(delta["w"])
    assert np.array_equal(p[0] - w, want), int((p[0] - w != want).sum())
    assert np.array_equal(p[0], _exact(w, g[0]))


def test_cohort_site_matches_the_reference(jx):
    """``_cohort_update``'s local steps rebuilt as the round builds them
    (jitted ``lax.scan``, gradient in the body, over K = 2 cohorts by
    ``vmap``) against the port's ``local_sgd`` without the STE, whose
    float32 leaves are strided views of the (K, D) parameters."""
    jax, jnp = jx.jax, jx.jnp
    w, g = _roadmap_input(rows=2)

    def step(p, gg):
        grad = jax.grad(lambda q: jnp.sum(q * gg))(p)
        return p - ETA * grad.astype(p.dtype), None

    run = jax.jit(jax.vmap(lambda gs: jax.lax.scan(step, jnp.asarray(w),
                                                   gs[None])[0]))
    want = np.asarray(run(jnp.asarray(g)))
    got = _port_local(w, g, quantizes_training=False)
    assert np.array_equal(got, want), int((got != want).sum())
    assert np.array_equal(want[0], _exact(w, g[0]))


def test_standard_site_matches_the_reference(jx):
    """The real ``make_standard_train_step`` (jitted) against the port's,
    one float32 leaf a launch."""
    jax, jnp = jx.jax, jx.jnp
    w, g = _roadmap_input()
    jcfg = jx.get_config("mnist_cnn")
    jcfg = dataclasses.replace(jcfg, fl=dataclasses.replace(
        jcfg.fl, learning_rate=ETA))

    class JModel:
        def loss(self, p, batch, key):
            return jnp.sum(p["w"] * batch["g"]), {}

    new, _ = jax.jit(jx.standard_step(JModel(), jcfg))(
        {"w": jnp.asarray(w)}, {"g": jnp.asarray(g[0])}, jax.random.PRNGKey(0))
    step = tsteps.make_standard_train_step(_LinearModel(False), _cfg(),
                                           device="cpu")
    got, _ = step(torch.from_numpy(w), {"g": torch.from_numpy(g[0])})
    want = np.asarray(new["w"])
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())


def test_bfloat16_step_keeps_its_product_and_difference(jx):
    """bfloat16 leaves step ``w - eta*g`` as before: equal to the
    reference's jitted bfloat16 step on C5's input."""
    jax, jnp = jx.jax, jx.jnp
    w, g = _roadmap_input()
    eta = float(torch.tensor(ETA, dtype=torch.bfloat16))

    def step(p, gg):
        grad = jax.grad(lambda q: jnp.sum(q.astype(jnp.float32) * gg))(p)
        return p - ETA * grad.astype(p.dtype), None

    want = jax.jit(lambda p, gs: jax.lax.scan(step, p, gs))(
        jnp.asarray(w, jnp.bfloat16), jnp.asarray(g))[0]
    leaf = torch.from_numpy(w).to(torch.bfloat16)
    tfl._step_(leaf, torch.from_numpy(g[0]).to(torch.bfloat16), eta)
    assert torch.equal(leaf.float(), torch.from_numpy(
        np.asarray(want, np.float32)))


def test_sgd_step_checks_its_operands():
    w = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        ops.fma_step_(w, torch.zeros(6, 4), 0.5)
    with pytest.raises(ValueError, match="float32 value"):
        ops.fma_step_(w, torch.zeros(4, 6), 0.1)
    with pytest.raises(TypeError):
        ops.fma_step_(w.double(), torch.zeros(4, 6).double(), 0.5)
    flat = torch.zeros(3, 20)
    leaf = flat[:, 4:16].view(3, 3, 4)
    assert ops._fma_rows(leaf, "w") == (3, 12, 20)
    assert ops._fma_rows(flat, "w") == (1, 60, 60)
    with pytest.raises(ValueError, match="rows"):
        ops._fma_rows(flat.t(), "w")
    ops.fma_step_(leaf, torch.ones(3, 3, 4), 0.5)
    assert float(flat.sum()) == -0.5 * 36 and float(flat[:, :4].abs().sum()) == 0


@pytest.mark.gpu
def test_cuda_sgd_step_matches_plain_version():
    """The kernel against ``fma32`` at the QNN's (10, 421,642), on C5's
    input, on strided leaves and on views off a 16-byte boundary (the
    element path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    eta = float(np.float32(ETA))
    neg = torch.tensor(-eta, device=dev)
    w0, g0 = _roadmap_input()
    flat = torch.randn(10, 421_642, generator=gen, device=dev) * 0.05
    cases = [(torch.from_numpy(w0).to(dev), torch.from_numpy(g0[0]).to(dev)),
             (flat.clone(), torch.randn(10, 421_642, generator=gen, device=dev)),
             (flat.clone()[:, 1:4097], torch.randn(10, 4096, generator=gen,
                                                    device=dev)),
             (flat.clone().reshape(-1)[3:1030],
              torch.randn(1027, generator=gen, device=dev))]
    for w, g in cases:
        want = tref.fma32(neg, g, w)
        plan = ops.fma_step_plan(w, g)
        before = ops.LAUNCHES["fma_step"]
        ops.fma_step_(w, g, eta)
        assert ops.LAUNCHES["fma_step"] == before + 1
        assert torch.equal(w, want), (tuple(w.shape), plan)
    assert ops.fma_step_plan(*cases[1]).vector
    assert not ops.fma_step_plan(*cases[3]).vector
    torch.cuda.synchronize()
