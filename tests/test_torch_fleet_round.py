"""The fleet paths of the port's two runtimes against the reference: the
unbiased IPW aggregate (``population.errors.reweighted_aggregate``, eq. 6's
kernel with a given denominator) bit for bit against the jitted reference,
``ipw_delta_scale``, one ``FLSimulator`` fleet round on the reference's own
draws, the cohort fleet round across wire formats, and the telemetry keys."""
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

from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core.fl import FLSimulator as JFLSimulator
from repro.models import build_model as jbuild_model
from repro.population import errors as jerrors
from repro.population import fleet as jfleet
from repro.population import telemetry as jtel
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.fl import FLSimulator, RoundNoise, make_fl_round
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model
from repro_torch.population import errors as terrors
from repro_torch.population import fleet as tfleet
from repro_torch.population import telemetry as ttel

Q, MIN_RATE = 0.3, 0.5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops; under the suite's parallel
    workers a thread pool per op only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ipw_inputs(K, D, seed):
    """Deltas, weights and a cohort with an unfilled slot, an outage slot
    (rate under MIN_RATE, so λ = 0 and out of the expected mass) and
    drops."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=D).astype(np.float32)
    deltas = (rng.normal(size=(K, D)) * 0.01).astype(np.float32)
    alphas = rng.uniform(0.01, 0.2, K).astype(np.float32)
    valid = np.ones(K, np.float32)
    rates = rng.uniform(0.6, 4.0, K).astype(np.float32)
    lam = (rng.uniform(size=K) >= Q).astype(np.float32)
    if K > 1:
        valid[-1] = 0.0
        rates[0] = 0.2
    lam = lam * valid * (rates > MIN_RATE)
    return w, deltas, alphas, valid, lam, rates


@jax.jit
def _jitted_reweighted(w, deltas, alphas, valid, lam, rates):
    return jerrors.reweighted_aggregate({"x": w}, {"x": deltas}, alphas,
                                        valid, lam, Q, rates=rates,
                                        min_rate=MIN_RATE)["x"]


def _port_reweighted(w, deltas, alphas, valid, lam, rates):
    t = [torch.from_numpy(a) for a in (w, deltas, alphas, valid, lam, rates)]
    return terrors.reweighted_aggregate(*t[:5], Q, rates=t[5],
                                        min_rate=MIN_RATE).numpy()


def test_reweighted_aggregate_bit_exact_at_the_main_shape():
    """(10, 421,642) with an unfilled slot, an outage slot and drops:
    w + fma-chain / max(Σ α·reach, EPS), equal to the jitted reference in
    every output."""
    args = _ipw_inputs(10, 421_642, 0)
    want = np.asarray(_jitted_reweighted(*args))
    got = _port_reweighted(*args)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [7, 4099])
def test_reweighted_aggregate_bit_exact_over_k(D):
    for K in range(1, 18):
        args = _ipw_inputs(K, D, K)
        np.testing.assert_array_equal(_port_reweighted(*args),
                                      np.asarray(_jitted_reweighted(*args)),
                                      err_msg=f"K={K} D={D}")


def test_plain_aggregate_with_den_divides_the_same_chain():
    """The plain version with ``den`` divides eq. 6's numerator as given:
    with den = max(Σ w, eps) it is eq. 6 to the bit."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.normal(size=(5, 999)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=5).astype(np.float32))
    total = torch.zeros(())
    for k in range(5):
        total = total + w[k]
    assert torch.equal(tref.masked_aggregate_ref(u, w, den=total),
                       tref.masked_aggregate_ref(u, w))


def test_ipw_delta_scale_equals_the_references():
    for seed in range(6):
        _, _, _, valid, lam, rates = _ipw_inputs(8, 3, seed)
        want = jerrors.ipw_delta_scale(jnp.asarray(lam), jnp.asarray(valid),
                                       jnp.asarray(rates), Q,
                                       min_rate=MIN_RATE)
        got = terrors.ipw_delta_scale(torch.from_numpy(lam),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(rates), Q,
                                      min_rate=MIN_RATE)
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the simulator's fleet round
# ---------------------------------------------------------------------------

def _fleet_cfg(get, *, K=4, I=2, size=64, reweight=True):
    cfg = get("mnist_cnn")
    return dataclasses.replace(
        cfg,
        fl=dataclasses.replace(cfg.fl, devices_per_round=K, local_iters=I,
                               learning_rate=0.05),
        channel=dataclasses.replace(cfg.channel, error_prob=Q,
                                    noise_psd_dbm=0.0),
        fleet=dataclasses.replace(cfg.fleet, size=size, selection="rate_aware",
                                  error_reweight=reweight),
        power=dataclasses.replace(cfg.power, policy="fbl_target"),
        train=dataclasses.replace(cfg.train, global_batch=8))


class _Weights:
    device = torch.device("cpu")

    def client_weights(self):
        return np.full(10, 0.1)


def _client_draws(k_cli, K, I, shapes):
    """The clients' draws of ``_fleet_round``: split(k_cli, K)
    (``core/fl.py:225``); per client split(r, I) and per step one uniform
    per leaf from split(key, n_leaves) (``quantization.py:318-319``); the
    uplink at fold_in(r, 7) (``fl.py:192``)."""
    names = sorted(shapes)

    def leaf_noise(key):
        keys = jax.random.split(key, len(names))
        return jnp.concatenate([jax.random.uniform(k, shapes[n]).ravel()
                                for k, n in zip(keys, names)])

    @jax.jit
    def draws(k_cli):
        rngs = jax.random.split(k_cli, K)
        steps = jax.vmap(lambda r: jax.random.split(r, I))(rngs)
        return (jax.vmap(jax.vmap(leaf_noise))(steps),
                jax.vmap(lambda r: leaf_noise(jax.random.fold_in(r, 7)))(rngs))

    return tuple(torch.from_numpy(np.array(a)) for a in draws(k_cli))


def test_fleet_round_matches_reference_on_its_draws():
    """One IPW fleet round (rate_aware, fbl_target, q = 0.3) on the QNN at
    K = 4 from the reference's fleet and draws: the same cohort, validity
    and λ, uplink codes as ``tests/test_torch_fl.py`` holds them, the
    parameters within one step, the fleet within rtol 1e-5, and the same
    telemetry keys."""
    K, I, B = 4, 2, 8
    cfg_j, cfg_t = _fleet_cfg(jget_config, K=K, I=I), _fleet_cfg(get_config,
                                                                 K=K, I=I)
    jmodel = jbuild_model(cfg_j)
    params_np = {k: np.asarray(v) for k, v in
                 jax.jit(jmodel.init)(jax.random.PRNGKey(1)).items()}
    data = np.random.default_rng(0)
    batches = {"images": data.normal(size=(K, I, B, 28, 28, 1)).astype(np.float32),
               "labels": data.integers(0, 10, (K, I, B)).astype(np.int32)}
    alphas = np.array([0.1, 0.25, 0.05, 0.2], np.float32)
    k_round = jax.random.PRNGKey(11)
    jsim = JFLSimulator(jmodel, cfg_j, _Weights())
    fleet0 = jsim.fleet_state

    @jax.jit
    def reference(params, fleet, batches, alphas, k_round):
        k_fleet, k_cli = jax.random.split(k_round)
        deltas, _, _ = jax.vmap(lambda b, r: jsim._client_update(params, b, r))(
            batches, jax.random.split(k_cli, K))
        _, info = jfleet.round_update(fleet, k_fleet, cfg_j, jsim.num_params, K)
        return (jsim._fleet_round(params, fleet, k_round, batches, alphas),
                deltas, info.lam)

    (jnew, jfl, jt), jdeltas, jlam = reference(
        {k: jnp.asarray(v) for k, v in params_np.items()}, fleet0,
        {k: jnp.asarray(v) for k, v in batches.items()}, jnp.asarray(alphas),
        k_round)
    k_fleet, k_cli = jax.random.split(k_round)
    from test_torch_population import reference_round_draws
    draws = reference_round_draws(k_fleet, cfg_j.fleet.size, K, "rate_aware")
    u_train, u_up = _client_draws(k_cli, K, I, {k: v.shape for k, v in
                                                params_np.items()})

    tsim = FLSimulator(build_model(cfg_t), cfg_t, _Weights(), device="cpu")
    tfleet0 = convert.fleet_from_numpy({k: np.asarray(v) for k, v in
                                        fleet0._asdict().items()}, "cpu")
    tparams = convert.flatten_params(convert.params_from_numpy(params_np, "cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    tdeltas, _, _ = tsim._client_update(tparams, tb, u_train=u_train, u_up=u_up)
    tnew, tfl, tt = tsim._fleet_round(tparams, tfleet0, tb,
                                      torch.from_numpy(alphas), draws=draws,
                                      u_train=u_train, u_up=u_up)

    np.testing.assert_array_equal(tt["selected"].numpy(), np.asarray(jt["selected"]))
    np.testing.assert_array_equal(tt["valid"].numpy(), np.asarray(jt["valid"]))
    assert float(tt["survivors"]) == float(jt["survivors"]) == float(jlam.sum())
    assert 0 < float(jlam.sum()) < K          # drops, and an IPW round
    jcodes = np.concatenate([np.asarray(jdeltas[k]).reshape(K, -1)
                             for k in sorted(params_np)], axis=1) * 128
    diff = np.abs(tdeltas.numpy() * 128 - jcodes)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    want = np.concatenate([np.asarray(jnew[k]).ravel() for k in sorted(params_np)])
    err = np.abs(tnew.numpy() - want)
    assert err.max() <= 1.0 / 128 and (err <= 1e-5).mean() >= 0.999
    for f in ("battery_j", "p_last", "h_re", "h_im"):
        np.testing.assert_allclose(getattr(tfl, f).numpy(),
                                   np.asarray(getattr(jfl, f)), rtol=1e-5,
                                   err_msg=f)
    assert set(tt) == set(jt)
    jhist = jtel.expand_history({k: v[None] for k, v in jt.items()}, 1)
    thist = ttel.expand_history(ttel.stack_rounds([tt]), 1)
    assert set(thist[0]) == set(jhist[0])
    assert thist[0]["selected"] == jhist[0]["selected"]


def test_fleet_simulator_rounds_conserve_battery_and_train():
    cfg = _fleet_cfg(get_config, size=200, reweight=False)
    from repro_torch.data.pipeline import make_federated_digits
    model = build_model(cfg)
    store = make_federated_digits(0, num_samples=300, num_clients=8,
                                  device="cpu")
    sim = FLSimulator(model, cfg, store, device="cpu")
    before = sim.fleet_state.battery_j.double().numpy()
    params = convert.flatten_params(model.init(1, device="cpu"))
    params, hist = sim.run_rounds(params, 3, 2)
    after = sim.fleet_state.battery_j.double().numpy()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(0 <= d < 200 for h in hist for d in h["selected"])
    np.testing.assert_allclose(np.sum(before - after),
                               sum(h["cohort_energy_j"] for h in hist),
                               rtol=1e-5, atol=1e-4)
    p2, tel = sim.run_round(params, 3)
    assert np.isfinite(tel.loss) and tel.energy_j > 0
    with pytest.raises(ValueError):
        FLSimulator(model, dataclasses.replace(
            cfg, fleet=dataclasses.replace(cfg.fleet, size=2)), store,
            device="cpu")


# ---------------------------------------------------------------------------
# the cohort round with a fleet
# ---------------------------------------------------------------------------

def test_cohort_fleet_round_bit_identical_across_wire_formats():
    """From one generator and fleet, int, packed, ring and rsag at (4,) and
    (2, 2) give the same parameters and the same fleet to the last bit
    over two rounds, the IPW scale applied after the collective."""
    C, I, micro = 4, 2, 8
    cfg = _fleet_cfg(get_config, K=C, I=I, size=1000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=C * I * micro))
    model = build_model(cfg)
    params0 = convert.flatten_params(model.init(1, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (C * I * micro, 28,
                                                            28, 1)).astype(np.float32)),
             "labels": torch.from_numpy(rng.integers(0, 10, C * I * micro))}
    fleet0 = tfleet.init_fleet(3, cfg, device="cpu")
    out = {}
    for sizes in ((4,), (2, 2)):
        for mode in ("int", "packed", "ring", "rsag"):
            fn = make_fl_round(model, cfg, sizes, collective=mode, device="cpu")
            gen = torch.Generator().manual_seed(5)
            params, fleet, ms = params0, fleet0, []
            for _ in range(2):
                params, m, fleet = fn(params, batch, gen, fleet)
                ms.append(m)
            out[sizes, mode] = params, fleet, ms
    params, fleet, ms = out[(4,), "int"]
    assert not torch.equal(params, params0)
    assert 0 < float(ms[0]["survivors"]) < C or 0 < float(ms[1]["survivors"]) < C
    for key, (p, f, _) in out.items():
        assert torch.equal(p, params), key
        for name in tfleet.FleetState._fields:
            assert torch.equal(getattr(f, name), getattr(fleet, name)), (key, name)
    plan = jagg.make_wire_plan("rsag", jget_config("mnist_cnn").quant,
                               ("data",), (4,))
    want = jtel.distributed_metrics_structure(plan, with_fleet=True)
    m = out[(4,), "rsag"][2][0]
    assert set(m) == set(want)
    assert set(m["wire_phase_bits_per_param"]) == set(
        want["wire_phase_bits_per_param"])
    with pytest.raises(ValueError):
        fn(params0, batch, torch.Generator())          # the fleet is missing
    with pytest.raises(ValueError):
        fn(params0, batch, None, fleet0,
           noise=RoundNoise(torch.zeros(C, I, params0.numel()), None,
                            torch.ones(C)))


_JAX_FLEET_ROUND = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.fl import make_fl_round
from repro.models import build_model
from repro.population import fleet as pfleet
from repro.utils.compat import make_mesh, set_mesh

C, I, B, Q, SEED, N = 4, 2, 32, 0.3, 8, 64
cfg = get_config("mnist_cnn")
cfg = dataclasses.replace(      # the port's _fleet_cfg(K=C, I=I, size=N)
    cfg,
    fl=dataclasses.replace(cfg.fl, devices_per_round=C, local_iters=I,
                           learning_rate=0.05),
    channel=dataclasses.replace(cfg.channel, error_prob=Q, noise_psd_dbm=0.0),
    fleet=dataclasses.replace(cfg.fleet, size=N, selection="rate_aware",
                              error_reweight=True),
    power=dataclasses.replace(cfg.power, policy="fbl_target"),
    train=dataclasses.replace(cfg.train, global_batch=B))
mesh = make_mesh((C,), ("data",))
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(1))
names = sorted(params)
fleet = pfleet.init_fleet(jax.random.PRNGKey(0), cfg)
data = np.random.default_rng(0)
batch = {"images": data.uniform(0, 1, (B, 28, 28, 1)).astype(np.float32),
         "labels": data.integers(0, 10, B).astype(np.int32)}
rng = jax.random.PRNGKey(SEED)
flat = lambda p: np.concatenate([np.asarray(p[k]).ravel() for k in names])
out = {"params": flat(params), **batch}
out.update({"fleet_in/" + k: np.asarray(v)
            for k, v in fleet._asdict().items()})
with set_mesh(mesh):
    fn = jax.jit(make_fl_round(model, cfg, mesh, collective="int"))
    new, m, fleet = fn(params, batch, rng, fleet)
out["new"] = flat(new)
out.update({"fleet_out/" + k: np.asarray(v)
            for k, v in fleet._asdict().items()})
out.update({"m/" + k: np.float32(v) for k, v in m.items()
            if not isinstance(v, dict)})

def leaf_noise(key):      # split(key, n_leaves), one uniform draw per leaf
    keys = jax.random.split(key, len(names))
    return np.concatenate([np.asarray(jax.random.uniform(
        k, params[n].shape, jnp.float32)).ravel() for k, n in zip(keys, names)])

u_train, u_up = [], []
for c in range(C):        # each cohort's key chain, fl.py:718 and :630-633
    rc = jax.random.fold_in(rng, c)
    u_train.append([leaf_noise(k) for k in jax.random.split(rc, I)])
    u_up.append(leaf_noise(jax.random.fold_in(rc, 13)))
np.savez(sys.argv[1], u_train=np.array(u_train), u_up=np.array(u_up), **out)
"""


def test_cohort_fleet_round_matches_the_real_make_fl_round(tmp_path):
    """The real JAX fleet round (``make_fl_round`` with a fleet, IPW on,
    rate_aware / fbl_target at q = 0.3) on a (4,) "data" host mesh in int
    against the port's on the CPU, from the reference's fleet on its own
    draws (the fleet's at fold_in(rng, 0xF1EE7), ``core/fl.py:698``): the
    cohort's λ enters through the survivors and the debited batteries, so
    a wrong cohort index or a misplaced IPW scale moves the parameters.
    The local steps' float sums run in another order than XLA's, so a
    weight code may flip in the second step and an uplink code differ by
    one (here 137 of 421,642 outputs, as in the fleet-free round on this
    key): the parameters are held as
    ``test_fleet_round_matches_reference_on_its_draws`` holds them, the
    mean loss within rtol 1e-4 (1.5e-5 here); survivors and the cursor
    equal, the fleet and its other metrics within rtol 1e-5."""
    from test_torch_population import reference_round_draws
    C, I, B, N, SEED = 4, 2, 32, 64, 8
    path = tmp_path / "fleet_round.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_FLEET_ROUND),
                        str(path)], capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    z = np.load(path)
    assert 0 < z["m/survivors"] < C            # drops, and an IPW round
    cfg = _fleet_cfg(get_config, K=C, I=I, size=N)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch=B))
    fn = make_fl_round(build_model(cfg), cfg, (C,), collective="int",
                       device="cpu")
    fleet = convert.fleet_from_numpy(
        {k: z["fleet_in/" + k] for k in tfleet.FleetState._fields}, "cpu")
    draws = reference_round_draws(
        jax.random.fold_in(jax.random.PRNGKey(SEED), 0xF1EE7), N, C,
        "rate_aware")
    lam = tfleet.round_update(fleet, None, cfg, z["params"].size, C,
                              draws=draws)[1].lam
    assert not torch.equal(lam, lam.flip(0))   # a cohort mix-up would show
    noise = RoundNoise(torch.from_numpy(z["u_train"]),
                       torch.from_numpy(z["u_up"]), None)
    new, m, fleet = fn(torch.from_numpy(z["params"]),
                       {"images": torch.from_numpy(z["images"]),
                        "labels": torch.from_numpy(z["labels"])},
                       None, fleet, noise=noise, fleet_draws=draws)
    err = np.abs(new.numpy() - z["new"])
    assert err.max() <= 1.0 / 128 and (err <= 1e-5).mean() >= 0.999
    assert float(m["survivors"]) == z["m/survivors"]
    assert int(fleet.rr_cursor) == int(z["fleet_out/rr_cursor"])
    for name in tfleet.FleetState._fields:
        np.testing.assert_allclose(getattr(fleet, name).numpy(),
                                   z["fleet_out/" + name], rtol=1e-5,
                                   err_msg=name)
    keys = {k[2:] for k in z.files if k.startswith("m/")}
    assert keys == {k for k, v in m.items() if not isinstance(v, dict)}
    for k in keys:
        np.testing.assert_allclose(np.float32(m[k]), z["m/" + k],
                                   rtol=1e-4 if k == "loss" else 1e-5,
                                   err_msg=k)
