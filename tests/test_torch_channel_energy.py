"""The port's channel and energy model against ``repro.core.channel`` /
``repro.core.energy`` on identical injected gains, plus moment checks on
the port's own samplers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ChannelConfig as JChannelConfig
from repro.config.base import EnergyConfig as JEnergyConfig
from repro.core import channel as jch
from repro.core import energy as jen
from repro_torch.config.base import ChannelConfig, EnergyConfig
from repro_torch.core import channel as tch
from repro_torch.core import energy as ten

GAINS = np.random.default_rng(0).exponential(1.0, 257).astype(np.float32)
D = 421_642


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


def test_qfunc_inv_matches_jax():
    q = np.array([1e-4, 1e-3, 0.01, 0.05, 0.1, 0.3, 0.5], np.float32)
    _close(tch.qfunc_inv(torch.from_numpy(q)).numpy(), jch.qfunc_inv(jnp.asarray(q)),
           rtol=1e-5)


@pytest.mark.parametrize("q", [0.001, 0.01, 0.3])
def test_fbl_rate_matches_jax(q):
    cfg = ChannelConfig(error_prob=q)
    for p in (0.001, 0.1, 2.0):
        s_t = tch.snr(p, torch.from_numpy(GAINS), cfg.noise_w)
        s_j = jch.snr(p, jnp.asarray(GAINS), cfg.noise_w)
        _close(s_t.numpy(), s_j)
        _close(tch.capacity(s_t).numpy(), jch.capacity(s_j))
        _close(tch.dispersion(s_t).numpy(), jch.dispersion(s_j))
        got = tch.fbl_rate(s_t, cfg.blocklength, q).numpy()
        want = np.asarray(jch.fbl_rate(s_j, cfg.blocklength, q))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # deep fades clip at zero rate
    assert float(tch.fbl_rate(torch.tensor([1e-9]), 1000, 0.01)[0]) == 0.0


def test_energy_and_latency_match_jax():
    e_t, c_t = EnergyConfig(), ChannelConfig()
    e_j, c_j = JEnergyConfig(), JChannelConfig()
    rate_np = np.maximum(np.asarray(jch.fbl_rate(
        jch.snr(c_j.tx_power_w, jnp.asarray(GAINS), c_j.noise_w),
        c_j.blocklength, c_j.error_prob)), 1e-9)
    rate = torch.from_numpy(rate_np)
    for bits in (1, 8, 32):
        _close(ten.local_training_energy_j(e_t, D, bits, 3),
               jen.local_training_energy_j(e_j, D, bits, 3))
        _close(ten.uplink_time_s(c_t, D, bits, rate), jen.uplink_time_s(c_j, D, bits, rate_np))
        _close(ten.uplink_energy_j(c_t, D, bits, rate),
               jen.uplink_energy_j(c_j, D, bits, rate_np))
        _close(ten.round_energy_j(e_t, c_t, num_params=D, bits=bits, local_iters=3,
                                  rate_bps_hz=rate),
               jen.round_energy_j(e_j, c_j, num_params=D, bits=bits, local_iters=3,
                                  rate_bps_hz=rate_np))
        kw = dict(num_params=D, bits=bits, local_iters=3, rates_per_device=rate,
                  num_devices=257, devices_per_round=10)
        kw_j = dict(kw, rates_per_device=rate_np)
        _close(ten.expected_total_energy_j(e_t, c_t, rounds=1.0, **kw),
               jen.expected_total_energy_j(e_j, c_j, rounds=1.0, **kw_j))
        _close(ten.round_time_s(e_t, c_t, macs_per_iter=4_241_152.0, **kw),
               jen.round_time_s(e_j, c_j, macs_per_iter=4_241_152.0, **kw_j))
    assert ten.compute_time_s(e_t, 4_241_152.0, 3) == jen.compute_time_s(e_j, 4_241_152.0, 3)
    _close(tch.transmission_time_s(D * 8.0, 10e6, rate).numpy(),
           jch.transmission_time_s(D * 8.0, 10e6, rate_np))


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_rayleigh_gain_mean_is_scale(scale):
    gen = torch.Generator().manual_seed(1)
    g2 = tch.sample_rayleigh_gain2(gen, (400_000,), scale)
    assert g2.dtype == torch.float32 and float(g2.min()) >= 0.0
    assert abs(float(g2.mean()) / scale - 1.0) < 0.01
    assert abs(float(g2.std()) / scale - 1.0) < 0.02     # Exp: std == mean


@pytest.mark.parametrize("q", [0.01, 0.3, 0.5])
def test_packet_success_rate_is_one_minus_q(q):
    gen = torch.Generator().manual_seed(2)
    lam = tch.sample_packet_success(gen, (400_000,), q)
    assert set(lam.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(lam.mean()) - (1 - q)) < 0.005


def test_fleet_channel_and_energy_helpers_match_jax():
    """The fleet's helpers on the reference's own draws: the stationary
    fading state and one AR(1) step (equal), E[r] over the reference's
    gains, the per-phase and deadline-capped uplink energy, the battery
    debit (equal, clipped at empty)."""
    import jax
    key = jax.random.PRNGKey(3)
    scale = jnp.asarray(GAINS[:64] + 0.1)
    k1, k2 = jax.random.split(key)
    normals = tuple(torch.from_numpy(np.array(jax.random.normal(k, (64,))))
                    for k in (k1, k2))
    want = jch.init_rayleigh_state(key, (64,), scale)
    got = tch.init_rayleigh_state(None, (64,), torch.from_numpy(np.array(scale)),
                                  normals=normals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    normals = tuple(torch.from_numpy(np.array(jax.random.normal(k, (64,))))
                    for k in (k1, k2))
    want = jch.gauss_markov_fading_step(jax.random.PRNGKey(4), *want, 0.9, scale)
    got = tch.gauss_markov_fading_step(None, *got, 0.9,
                                       torch.from_numpy(np.array(scale)),
                                       normals=normals)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    ccfg = ChannelConfig(error_prob=0.05, tx_power_w=0.01)
    jcfg = JChannelConfig(error_prob=0.05, tx_power_w=0.01)
    g2 = jch.sample_rayleigh_gain2(jax.random.PRNGKey(5), (4096,), 1.0)
    _close(float(tch.expected_rate(ccfg, None, gain2=torch.from_numpy(np.array(g2)))),
           float(jch.expected_rate(jcfg, jax.random.PRNGKey(5))))
    rates = torch.from_numpy(GAINS * 2)
    phases = {"reduce_scatter": 13.2, "all_gather": 13.2}
    want = jen.uplink_phase_energy_j(jcfg, D, phases, jnp.asarray(GAINS * 2))
    for k, v in ten.uplink_phase_energy_j(ccfg, D, phases, rates).items():
        _close(v.numpy(), want[k])
    _close(ten.capped_uplink_energy_j(ccfg, D, 8, rates, 1.0).numpy(),
           jen.capped_uplink_energy_j(jcfg, D, 8, jnp.asarray(GAINS * 2), 1.0))
    battery = np.array([5.0, 0.2, 3.0], np.float32)
    jb, jc = jen.battery_debit_j(jnp.asarray(battery), jnp.asarray([0, 1]),
                                 jnp.asarray([1.0, 1.0]))
    tb, tc = ten.battery_debit_j(torch.from_numpy(battery), torch.tensor([0, 1]),
                                 torch.tensor([1.0, 1.0]))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
