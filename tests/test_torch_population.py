"""The port's population layer (``repro_torch.population``) against
``repro.population``: ``round_update`` on the reference's own draws and
fleet for every selection × power policy, the selection's tie order
against ``jax.lax.top_k``, and the invariants of ``tests/test_population.py``
and ``tests/test_power.py`` on the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.population import fleet as jfleet
from repro.population import power as jpower
from repro.population import selection as jsel
from repro_torch import convert
from repro_torch.config.base import POWER_POLICIES, SELECTION_POLICIES
from repro_torch.configs import get_config
from repro_torch.core import channel as tch
from repro_torch.population import errors as terrors
from repro_torch.population import fleet as tfleet
from repro_torch.population import power as tpower
from repro_torch.population import selection as tsel

N_PARAMS = 421_642  # the paper QNN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops; under the suite's parallel
    workers a thread pool per op only contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, size, selection="uniform", policy="fixed", *, power=None,
         channel=None, fleet=None):
    cfg = get("mnist_cnn")
    return dataclasses.replace(
        cfg,
        power=dataclasses.replace(cfg.power, policy=policy, **(power or {})),
        channel=dataclasses.replace(cfg.channel, **(channel or {})),
        fleet=dataclasses.replace(cfg.fleet, size=size, selection=selection,
                                  **(fleet or {})))


def _pair(size, selection="uniform", policy="fixed", **kw):
    """(reference config, port config, reference fleet, the same fleet in
    the port on the CPU)."""
    jc, tc = _cfg(jget_config, size, selection, policy, **kw), _cfg(
        get_config, size, selection, policy, **kw)
    js = jfleet.init_fleet(jax.random.PRNGKey(0), jc)
    ts = convert.fleet_from_numpy({k: np.asarray(v) for k, v in
                                   js._asdict().items()}, "cpu")
    return jc, tc, js, ts


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_round_draws(key, n, k, selection):
    """``round_update``'s draws rebuilt from its key chain: split(key, 3)
    into channel, selection and drop keys (``population/fleet.py:310``);
    the channel key split into fading and availability (``:160``), the
    fading key into the two normals (``core/channel.py:95``)."""
    k_ch, k_sel, k_drop = jax.random.split(key, 3)
    k_fade, k_avail = jax.random.split(k_ch)
    k1, k2 = jax.random.split(k_fade)
    return tfleet.RoundDraws(
        _t(jax.random.normal(k1, (n,), jnp.float32)),
        _t(jax.random.normal(k2, (n,), jnp.float32)),
        _t(jax.random.uniform(k_avail, (n,))),
        _t(jax.random.uniform(k_sel, (n,))) if selection == "uniform" else None,
        _t(jax.random.uniform(k_drop, (k,))))


def _reference_scores(jc, js, key):
    """The reference's masked selection scores for the round ``key`` starts
    from state ``js``, as its ``select_cohort`` ranks them (the lyapunov
    score, the only one built from fleet means)."""
    k_ch = jax.random.split(key, 3)[0]
    st = jfleet.advance_channel(js, k_ch, jc)
    p = jpower.assigned_power(jc, st.gain2(), st.battery_j, st.capacity_j,
                              N_PARAMS)
    rates = jfleet.fleet_rates(st, jc.channel, p)
    cost = jfleet.round_cost_j(jc, rates, N_PARAMS, tx_power_w=p)
    scores = jsel.policy_scores(jc.fleet.selection, st, rates, k_ch, cost,
                                jc.power.lyapunov_v)
    return np.asarray(jnp.where(jsel.eligible_mask(st, cost) > 0,
                                scores.astype(jnp.float32), -jnp.inf))


def _assert_cohort(ji, ti, selection, ref_scores):
    """idx equal; under ``lyapunov`` selection, where the two differ, the
    reference scores the port's pick and its own pick within 2 float32
    ulps (ROADMAP C3: its fleet means differ in the last bit)."""
    jidx, tidx = np.asarray(ji.idx), ti.idx.numpy()
    if selection != "lyapunov" or np.array_equal(jidx, tidx):
        np.testing.assert_array_equal(tidx, jidx)
        return
    a, b = ref_scores[jidx], ref_scores[tidx]
    assert np.all(np.abs(a - b) <= 2 * np.spacing(np.abs(a).astype(np.float32)))


@pytest.mark.parametrize("policy", POWER_POLICIES)
@pytest.mark.parametrize("selection", SELECTION_POLICIES)
def test_round_update_matches_reference_on_its_draws(selection, policy):
    """Ten rounds from the reference's own fleet on its own draws, at a
    noise floor where every power policy bites (0 dBm, as
    ``benchmarks/power_policies.py``) and with harvesting on: the cohort,
    its validity, drops and outage equal; battery, power and rates within
    rtol 1e-5."""
    n, k = 1000, 16
    jc, tc, js, ts = _pair(n, selection, policy,
                           channel={"noise_psd_dbm": 0.0},
                           fleet={"harvest_j_per_round": 0.05})
    key = jax.random.PRNGKey(5)
    for _ in range(10):
        key, kr = jax.random.split(key)
        scores = (_reference_scores(jc, js, kr) if selection == "lyapunov"
                  else None)
        js, ji = jfleet.round_update(js, kr, jc, N_PARAMS, k)
        ts, ti = tfleet.round_update(
            ts, None, tc, N_PARAMS, k,
            draws=reference_round_draws(kr, n, k, selection))
        _assert_cohort(ji, ti, selection, scores)
        if scores is not None:
            # the scores the port ranked: eligibility exact, and the
            # lyapunov score (a difference of two terms) within 1e-6
            np.testing.assert_array_equal(np.isneginf(ti.scores.numpy()),
                                          np.isneginf(scores))
            np.testing.assert_allclose(ti.scores.numpy(), scores, rtol=1e-5,
                                       atol=1e-6)
        for f in ("valid", "lam", "outage_sel"):
            np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                          np.asarray(getattr(ji, f)), f)
        for f in ("battery_j", "p_last", "h_re", "h_im", "available"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=0, err_msg=f)
        np.testing.assert_allclose(ti.rates_sel.numpy(),
                                   np.asarray(ji.rates_sel), rtol=1e-5)
        np.testing.assert_allclose(float(ti.harvest_j), float(ji.harvest_j),
                                   rtol=1e-5)
        assert int(ts.rr_cursor) == int(js.rr_cursor)


@pytest.mark.parametrize("case", ["all_ineligible", "fewer_than_k",
                                  "equal_batteries"])
def test_selection_ties_in_top_k_order(case):
    """Tied scores rank the lower index first, as ``jax.lax.top_k``: every
    device ineligible (all -inf), fewer eligible than slots (the padding
    holds ineligible ids), and equal batteries under energy_aware."""
    n, k = 64, 12
    selection = "round_robin" if case == "fewer_than_k" else "energy_aware"
    jc, tc, js, ts = _pair(n, selection)
    battery = np.full(n, 10.0, np.float32)
    if case == "all_ineligible":
        battery[:] = 0.0
    elif case == "fewer_than_k":
        battery[::7] = 0.0
        battery[5:] = 0.0
        battery[40:44] = 10.0
    else:
        battery[::3] = 5.0                     # three tiers of equal values
        battery[1::5] = 0.0
    cost = np.full(n, 1.0, np.float32)
    js = js._replace(battery_j=jnp.asarray(battery))
    ts = ts._replace(battery_j=torch.from_numpy(battery.copy()))
    rates = jfleet.fleet_rates(js, jc.channel)
    jidx, jvalid = jsel.select_cohort(selection, js, rates, k,
                                      jax.random.PRNGKey(0), jnp.asarray(cost))
    tidx, tvalid = tsel.select_cohort(selection, ts, _t(rates), k, None,
                                      torch.from_numpy(cost))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    want_valid = {"all_ineligible": 0, "fewer_than_k": 8, "equal_batteries": k}
    assert float(tvalid.sum()) == want_valid[case]


# ---------------------------------------------------------------------------
# invariants, on the port alone
# ---------------------------------------------------------------------------

def _state(n=32, battery=None, available=None, seed=0, **kw):
    cfg = _cfg(get_config, n, **kw)
    st = tfleet.init_fleet(seed, cfg, device="cpu")
    if battery is not None:
        st = st._replace(battery_j=torch.tensor(battery, dtype=torch.float32))
    if available is not None:
        st = st._replace(available=torch.tensor(available, dtype=torch.float32))
    return cfg, st


@pytest.mark.parametrize("selection", SELECTION_POLICIES)
def test_dead_or_unavailable_devices_never_selected(selection):
    n, k = 32, 6
    battery = np.full(n, 10.0, np.float32)
    battery[::3] = 0.0
    available = np.ones(n, np.float32)
    available[::4] = 0.0
    cfg, st = _state(n, battery, available)
    cost = torch.full((n,), 1.0)
    rates = tfleet.fleet_rates(st, cfg.channel)
    ineligible = set(np.where((battery < 1.0) | (available == 0))[0])
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        idx, valid = tsel.select_cohort(selection, st, rates, k, gen, cost)
        chosen = idx.numpy()[valid.numpy() > 0]
        assert not set(chosen.tolist()) & ineligible, (selection, chosen)
        assert len(set(chosen.tolist())) == len(chosen)


def test_gauss_markov_autocorrelation_and_stationarity():
    """Lag-1 autocorrelation of the fading components ≈ ρ, and the gain
    stays Exp(scale)."""
    rho, scale, n, T = 0.7, 1.3, 256, 1500
    gen = torch.Generator().manual_seed(0)
    h = tch.init_rayleigh_state(gen, (n,), scale)
    xs = []
    for _ in range(T):
        h = tch.gauss_markov_fading_step(gen, *h, rho, scale)
        xs.append(h[0])
    x = torch.stack(xs).double().numpy()
    autocorr = np.mean(x[1:] * x[:-1]) / np.mean(x * x)
    assert abs(autocorr - rho) < 0.03, autocorr
    np.testing.assert_allclose(np.mean(x * x), scale / 2.0, rtol=0.05)
    h = tch.init_rayleigh_state(gen, (20_000,), scale)
    for _ in range(50):
        h = tch.gauss_markov_fading_step(gen, *h, rho, scale)
    np.testing.assert_allclose(float((h[0] ** 2 + h[1] ** 2).mean()), scale,
                               rtol=0.05)


@pytest.mark.parametrize("harvest", [0.0, 0.15])
def test_battery_conserved_exactly(harvest):
    """Over rounds the fleet's energy moves by exactly Σ harvested − Σ
    charged (per-device differences summed in float64)."""
    cfg, st = _state(200, selection="energy_aware",
                     fleet={"harvest_j_per_round": harvest})
    before = st.battery_j.double().numpy()
    gen = torch.Generator().manual_seed(2)
    charged = harvested = 0.0
    for _ in range(5):
        st, info = tfleet.round_update(st, gen, cfg, N_PARAMS, 8)
        charged += info.charge_j.double().sum().item()
        harvested += float(info.harvest_j)
    after = st.battery_j.double().numpy()
    np.testing.assert_allclose(np.sum(before - after), charged - harvested,
                               rtol=1e-5, atol=1e-4)
    assert charged > 0 and (harvested > 0) == (harvest > 0)
    assert np.all(after >= 0)
    assert np.all(after <= st.capacity_j.numpy() + 1e-5)


@pytest.mark.parametrize("policy", ["channel_inversion", "fbl_target"])
def test_monte_carlo_outage_meets_configured_target(policy):
    """With a generous power box the adaptive policies keep every device
    above the deadline rate, and the realized drop rate stays at the
    configured q within Monte Carlo noise."""
    q = 0.05
    cfg, st = _state(512, policy=policy,
                     power={"target_snr_db": 6.0, "p_max": 1e6},
                     channel={"noise_psd_dbm": 20.0, "error_prob": q})
    r_min = tpower.min_rate(cfg, N_PARAMS)
    gen = torch.Generator().manual_seed(7)
    drops, n = 0.0, 0
    for _ in range(20):
        st = tfleet.advance_channel(st, gen, cfg)
        p = tpower.assigned_power(cfg, st.gain2(), st.battery_j,
                                  st.capacity_j, N_PARAMS)
        rates = tfleet.fleet_rates(st, cfg.channel, p)
        assert float(rates.min()) > r_min
        lam = terrors.realize_packet_success(gen, rates, q, min_rate=r_min)
        drops += float((1.0 - lam).sum())
        n += rates.shape[0]
    assert drops / n <= q + 3.0 * np.sqrt(q * (1 - q) / n), drops / n


def test_fbl_target_is_minimal_deadline_meeting_power():
    """Unclipped fbl_target devices reach the deadline rate (× margin), and
    10 % less power misses it; devices clipped at p_max are the predicted
    outage set."""
    cfg, st = _state(256, policy="fbl_target",
                     channel={"noise_psd_dbm": 25.0})
    p = tpower.assigned_power(cfg, st.gain2(), st.battery_j, st.capacity_j,
                              N_PARAMS)
    rates = tfleet.fleet_rates(st, cfg.channel, p)
    r_min = tpower.deadline_rate(cfg, N_PARAMS)
    pn = p.numpy()
    inner = (pn > cfg.power.p_min * 1.0001) & (pn < cfg.power.p_max * 0.9999)
    assert inner.any()
    np.testing.assert_allclose(rates.numpy()[inner], r_min, rtol=1e-3)
    under = tfleet.fleet_rates(st, cfg.channel, p * 0.9)
    assert np.all(under.numpy()[inner] < r_min)
    assert np.all(rates.numpy()[pn >= cfg.power.p_max * 0.9999] < r_min)


def test_required_snr_round_trips_and_matches_reference():
    targets = np.array([0.05, 0.5, 5.0, 20.0], np.float32)
    s = tpower.required_snr_for_rate(torch.from_numpy(targets), 1000, 0.01)
    np.testing.assert_allclose(tch.fbl_rate(s, 1000, 0.01).numpy(), targets,
                               rtol=1e-4)
    want = jpower.required_snr_for_rate(jnp.asarray(targets), 1000, 0.01)
    np.testing.assert_allclose(s.numpy(), np.asarray(want), rtol=1e-5)
    # A Python target, as the reference's own test passes one, runs where
    # ``device`` says; each equals its element of the vectorized call.
    for t, si in zip(targets, s):
        one = tpower.required_snr_for_rate(float(t), 1000, 0.01, device="cpu")
        assert one.device.type == "cpu" and torch.equal(one, si)


def test_registries_and_config_checks():
    assert tsel.POLICIES == SELECTION_POLICIES
    assert tpower.POLICIES == POWER_POLICIES
    cfg, st = _state(8)
    with pytest.raises(ValueError):
        tsel.policy_scores("bogus", st, torch.zeros(8))
    for bad in ({"p_min": 0.0}, {"p_min": 3.0}, {"p_fixed": -0.5},
                {"policy": "bogus"}):
        c = dataclasses.replace(cfg, power=dataclasses.replace(cfg.power,
                                                               **bad))
        with pytest.raises(ValueError):
            tfleet.init_fleet(0, c, device="cpu")


def test_init_fleet_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(get_config, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfleet.init_fleet(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpower.required_snr_for_rate(0.5, 1000, 0.01)


def test_calibrate_fixed_power_closes_the_cmaes_loop():
    """``calibrate_fixed_power`` lands the CMA-ES optimum in power.p_fixed
    and channel.error_prob, inside the paper's box, and the fixed policy
    then assigns it to every device."""
    cfg, st = _state(64)
    out = tpower.calibrate_fixed_power(
        cfg, num_params=N_PARAMS, macs_per_iter=cfg.energy.macs_per_iteration,
        max_iters=3, device="cpu")
    assert out.power.policy == "fixed"
    assert 0.1 <= out.power.p_fixed <= 2.0
    assert 0.01 <= out.channel.error_prob <= 0.99
    p = tpower.assigned_power(out, st.gain2(), st.battery_j, st.capacity_j,
                              N_PARAMS)
    np.testing.assert_allclose(p.numpy(), np.float32(out.power.p_fixed))


def test_percentiles_match_jnp_percentile():
    from repro_torch.population import telemetry as ttel
    x = np.random.default_rng(0).exponential(size=1001).astype(np.float32)
    qs = (10.0, 50.0, 90.0)
    np.testing.assert_allclose(ttel.percentiles(torch.from_numpy(x), qs).numpy(),
                               np.asarray(jnp.percentile(jnp.asarray(x),
                                                         jnp.asarray(qs))),
                               rtol=1e-6)
