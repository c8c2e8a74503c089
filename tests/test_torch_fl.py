"""The port's simulator (``repro_torch.core.fl``) against
``repro.core.fl.FLSimulator``: one round on the reference's own draws,
the paper's headline behaviours on the port alone, and the device rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core.fl import FLSimulator as JFLSimulator
from repro.models import build_model as jbuild_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.mnist_cnn import PAPER_WEIGHTS
from repro_torch.core import aggregation as tagg
from repro_torch.core.fl import FLSimulator
from repro_torch.data.pipeline import ClientStore, make_federated_digits
from repro_torch.data.synthetic import digit_dataset, partition_dirichlet, partition_iid
from repro_torch.models import build_model


def _with_fl(cfg, *, K, I, lr=0.05, q=0.01, error_aware=True, batch=16):
    return dataclasses.replace(
        cfg,
        fl=dataclasses.replace(cfg.fl, devices_per_round=K, local_iters=I,
                               learning_rate=lr, error_aware=error_aware),
        channel=dataclasses.replace(cfg.channel, error_prob=q),
        train=dataclasses.replace(cfg.train, global_batch=batch))


class _Weights:
    """The two simulators' constructors read only the client weights (and,
    in the port, the store's device)."""
    device = torch.device("cpu")

    def client_weights(self):
        return np.full(10, 0.1)


def _reference_draws(rng, K, I, q, shapes):
    """Rebuild FLSimulator._round's draws from its key chain: split(rng,
    K+1) (fl.py:199); per client split(r, I) (:188) and per step one
    uniform per leaf from split(key, 8) (quantization.py:318-319); the
    uplink at fold_in(r, 7) (fl.py:192, quantization.py:91); λ from
    uniform(rngs[K], (K,)) >= q (channel.py:117-119)."""
    names = sorted(shapes)

    def leaf_noise(key):
        keys = jax.random.split(key, len(names))
        return jnp.concatenate([jax.random.uniform(k, shapes[n], jnp.float32).ravel()
                                for k, n in zip(keys, names)])

    @jax.jit
    def draws(rng):
        rngs = jax.random.split(rng, K + 1)
        step_keys = jax.vmap(lambda r: jax.random.split(r, I))(rngs[:K])
        u_train = jax.vmap(jax.vmap(leaf_noise))(step_keys)
        u_up = jax.vmap(lambda r: leaf_noise(jax.random.fold_in(r, 7)))(rngs[:K])
        lam = (jax.random.uniform(rngs[K], (K,)) >= q).astype(jnp.float32)
        return u_train, u_up, lam

    return tuple(np.array(a) for a in draws(rng))


def test_one_round_matches_reference_on_its_own_draws():
    K, I, B, q = 3, 2, 8, 0.3
    cfg_j = _with_fl(jget_config("mnist_cnn"), K=K, I=I, q=q)
    cfg_t = _with_fl(get_config("mnist_cnn"), K=K, I=I, q=q)
    jmodel = jbuild_model(cfg_j)
    params_np = {k: np.asarray(v) for k, v in jax.jit(jmodel.init)(jax.random.PRNGKey(1)).items()}
    data = np.random.default_rng(0)
    batches = {"images": data.normal(size=(K, I, B, 28, 28, 1)).astype(np.float32),
               "labels": data.integers(0, 10, (K, I, B)).astype(np.int32)}
    alphas = np.array([0.1, 0.25, 0.05], np.float32)
    rng = jax.random.PRNGKey(11)

    jsim = JFLSimulator(jmodel, cfg_j, _Weights())

    @jax.jit
    def reference(params, batches, alphas, rng):
        """FLSimulator._round, and the uplink deltas its clients sent."""
        rngs = jax.random.split(rng, K + 1)
        deltas, _, _ = jax.vmap(lambda b, r: jsim._client_update(params, b, r))(
            batches, rngs[:K])
        return jsim._round(params, batches, alphas, rng), deltas

    (jnew, jloss, _, jsurv), jdeltas = reference(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.asarray(alphas), rng)
    jcodes = np.concatenate([np.asarray(jdeltas[k]).reshape(K, -1) for k in sorted(params_np)],
                            axis=1) * 128

    u_train, u_up, lam = _reference_draws(rng, K, I, q, {k: v.shape for k, v in params_np.items()})
    tsim = FLSimulator(build_model(cfg_t), cfg_t, _Weights(), device="cpu")
    tparams = convert.flatten_params(convert.params_from_numpy(params_np, "cpu"))
    tbatches = {k: torch.from_numpy(v) for k, v in batches.items()}
    tdeltas, _, _ = tsim._client_update(tparams, tbatches, u_train=torch.from_numpy(u_train),
                                        u_up=torch.from_numpy(u_up))
    tnew, tloss, _, tsurv = tsim._round(tparams, tbatches, torch.from_numpy(alphas),
                                        u_train=torch.from_numpy(u_train),
                                        u_up=torch.from_numpy(u_up),
                                        lam=torch.from_numpy(lam))

    tcodes = tdeltas.numpy() * 128
    assert np.array_equal(tcodes, np.round(tcodes))      # deltas are on the code grid
    diff = np.abs(tcodes - jcodes)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    assert float(tsurv) == float(jsurv) == lam.sum()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = np.concatenate([np.asarray(jnew[k]).ravel() for k in sorted(params_np)])
    err = np.abs(tnew.numpy() - want)
    assert err.max() <= 1.0 / 128
    assert (err <= 1e-5).mean() >= 0.999


def _small_fl_config(**kw):
    return _with_fl(get_config("mnist_cnn"), K=3, I=2, **kw)


def test_fl_simulator_loss_decreases():
    cfg = _small_fl_config()
    model = build_model(cfg)
    store = make_federated_digits(0, num_samples=600, num_clients=10, device="cpu")
    sim = FLSimulator(model, cfg, store, device="cpu")
    assert sim.num_params == PAPER_WEIGHTS
    params = convert.flatten_params(model.init(1, device="cpu"))
    params, hist = sim.train(params, 6, 2)
    assert hist[-1]["loss"] < hist[0]["loss"], "FL training must reduce loss"
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[0]["energy_j"] > 0 and hist[0]["tau_s"] > 0
    assert bool(torch.isfinite(params).all())


def test_fl_simulator_error_aware_beats_naive_at_high_q():
    """At q=0.5, eq. 6 renormalization should track eq. 5 or better."""
    results = {}
    for aware in (True, False):
        cfg = _small_fl_config(q=0.5, error_aware=aware)
        model = build_model(cfg)
        store = make_federated_digits(3, num_samples=400, num_clients=10, device="cpu")
        sim = FLSimulator(model, cfg, store, device="cpu")
        params = convert.flatten_params(model.init(4, device="cpu"))
        _, hist = sim.train(params, 5, 5)
        results[aware] = hist[-1]["loss"]
    assert np.isfinite(results[True]) and np.isfinite(results[False])
    assert results[True] <= results[False] * 1.5


def test_round_energy_is_drawn_once(monkeypatch):
    from repro_torch.core import fl as tfl
    calls = []
    draw = tfl.ch.sample_rayleigh_gain2
    monkeypatch.setattr(tfl.ch, "sample_rayleigh_gain2",
                        lambda *a, **kw: calls.append(1) or draw(*a, **kw))
    cfg = _small_fl_config()
    sim = FLSimulator(build_model(cfg), cfg, _Weights(), device="cpu")
    e, tau = sim.round_energy()
    assert e > 0 and tau > 0
    assert sim.round_energy() == (e, tau)
    assert len(calls) == 1


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_fl_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_federated_digits(0, num_samples=50, num_clients=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg).init(0)
    store = make_federated_digits(0, num_samples=50, num_clients=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLSimulator(build_model(cfg), cfg, store)


@pytest.mark.parametrize("aware", [True, False])
def test_aggregation_matches_jax_pure_forms(aware):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(50,)).astype(np.float32)
    deltas = rng.normal(0, 0.01, (4, 50)).astype(np.float32)
    alphas = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    for lam in (np.array([1, 0, 1, 1], np.float32), np.zeros(4, np.float32)):
        if aware:
            want = jagg.error_aware_aggregate({"w": jnp.asarray(w)}, {"w": jnp.asarray(deltas)},
                                              jnp.asarray(alphas), jnp.asarray(lam))["w"]
            got = tagg.error_aware_aggregate(torch.from_numpy(w), torch.from_numpy(deltas),
                                             torch.from_numpy(alphas), torch.from_numpy(lam))
        else:
            want = jagg.naive_aggregate({"w": jnp.asarray(w)}, {"w": jnp.asarray(deltas)},
                                        jnp.asarray(lam))["w"]
            got = tagg.naive_aggregate(torch.from_numpy(w), torch.from_numpy(deltas),
                                       torch.from_numpy(lam))
        # the eager reference runs one op at a time and does not contract
        # its multiply into the sum, while the port follows the jitted form
        # (one fused multiply-add a client; tests/test_torch_aggregate_fma.py)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_client_batches_come_from_each_clients_shard():
    gen = torch.Generator().manual_seed(0)
    data = {"x": torch.arange(40).float(), "labels": torch.arange(40)}
    parts = [torch.arange(0, 30), torch.arange(30, 35), torch.arange(35, 40)]
    store = ClientStore(data, parts)
    clients = torch.tensor([0, 1, 2])
    out = store.client_batches(gen, clients, 4, 8)
    assert out["x"].shape == (3, 4, 8) and out["labels"].shape == (3, 4, 8)
    for k, c in enumerate(clients.tolist()):
        assert set(out["labels"][k].flatten().tolist()) <= set(parts[c].tolist())
    # a shard at least as large as the batch is sampled without replacement
    for i in range(4):
        assert len(set(out["labels"][0, i].tolist())) == 8
    np.testing.assert_allclose(store.client_weights(), [0.75, 0.125, 0.125])


def test_partitions_cover_all_samples():
    gen = torch.Generator().manual_seed(6)
    data = digit_dataset(gen, 500)
    assert data["images"].shape == (500, 28, 28, 1) and data["images"].dtype == torch.float32
    assert int(data["labels"].min()) >= 0 and int(data["labels"].max()) < 10
    for parts in (partition_iid(gen, 500, 7),
                  partition_dirichlet(gen, data["labels"], 7, alpha=0.3)):
        allidx = torch.cat(parts)
        assert len(allidx) == 500 and len(allidx.unique()) == 500
