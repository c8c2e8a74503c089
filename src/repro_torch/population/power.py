"""Per-device adaptive uplink power control (the PowerPolicy layer).

The paper fixes ONE transmit power for the whole fleet and optimizes it
once on the host (§III eq. 20, CMA-ES over (P_tx, q) in
``core/optimize.py``).  This module assigns every device its own
``tx_power_w`` each round from its current state — elementwise torch over
(N,) vectors on the fleet's device, with no randomness and no host
round-trip, so both runtimes compute the identical vector and the cohort
round stays bit-identical across wire formats.

Policies (``PowerConfig.policy``):

  fixed              p_i = ``p_fixed`` (0 → ``ChannelConfig.tx_power_w``),
                     seeded from the CMA-ES optimum by
                     :func:`calibrate_fixed_power`.
  channel_inversion  p_i = ρ_t·N₀/|h_i|² targeting ``target_snr_db``,
                     clipped to [p_min, p_max].
  fbl_target         the minimum SNR whose FBL rate at the configured
                     ``error_prob`` completes the d·n uplink inside
                     ``tau_limit_s`` (:func:`required_snr_for_rate`), then
                     p_i = ρ*·N₀/|h_i|² clipped to [p_min, p_max]; devices
                     the p_max clip cannot lift are in predicted outage.
  lyapunov           each device picks, from a fixed log-spaced grid, the
                     power maximizing V·rate − drift·energy, drift growing
                     toward 1 as its battery drains.  The same score at the
                     assigned power is the ``lyapunov`` selection policy.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.config.base import (POWER_POLICIES, ChannelConfig, Config,
                                     PowerConfig)
from repro_torch.core import channel as ch
from repro_torch.device import DeviceLike, resolve_device

POLICIES = POWER_POLICIES

#: candidate powers evaluated by the lyapunov grid search
LYAPUNOV_GRID = 16
#: drift never vanishes entirely — a full battery still prices energy
DRIFT_FLOOR = 0.05
_EPS = 1e-30


def validate_config(pcfg: PowerConfig) -> None:
    """Reject degenerate power boxes up front (``init_fleet`` calls this):
    a non-positive ``p_min`` collapses the lyapunov log-grid and lets the
    inversion policies assign 0 W, and ``p_min > p_max`` makes the clip
    return ``p_max`` silently."""
    if pcfg.policy not in POLICIES:
        raise ValueError(f"unknown power.policy {pcfg.policy!r}; "
                         f"expected one of {POLICIES}")
    if pcfg.p_min <= 0:
        raise ValueError(f"power.p_min must be > 0, got {pcfg.p_min}")
    if pcfg.p_min > pcfg.p_max:
        raise ValueError(f"power.p_min {pcfg.p_min} exceeds "
                         f"power.p_max {pcfg.p_max}")
    if pcfg.p_fixed < 0:
        raise ValueError(f"power.p_fixed must be >= 0, got {pcfg.p_fixed}")


def uplink_bits(config: Config) -> int:
    """The n of the d·n uplink payload (32 when quantization is off)."""
    qcfg = config.quant
    return qcfg.bits if (qcfg.enabled and qcfg.quantize_uplink) else 32


def fixed_power_w(pcfg: PowerConfig | None, ch_cfg: ChannelConfig) -> float:
    """The fixed-policy scalar: ``p_fixed`` or the config's P_tx — the one
    place the population layer reads ``ChannelConfig.tx_power_w``."""
    return (pcfg.p_fixed if pcfg is not None and pcfg.p_fixed > 0
            else ch_cfg.tx_power_w)


def _f32(x: float) -> torch.Tensor:
    """float32(x) as a 0-dim CPU tensor.  Dividing it by a tensor is one
    true division on any device, where a Python number over a tensor is a
    reciprocal times the number (two roundings)."""
    return torch.tensor(x, dtype=torch.float32)


def _clip_power(p: torch.Tensor, pcfg: PowerConfig) -> torch.Tensor:
    return torch.clamp(p, pcfg.p_min, pcfg.p_max).float()


def channel_inversion_power(pcfg: PowerConfig, ch_cfg: ChannelConfig,
                            gain2: torch.Tensor) -> torch.Tensor:
    """Truncated inversion: hit ``target_snr_db`` at the current gain."""
    snr_t = 10.0 ** (pcfg.target_snr_db / 10.0)
    p = _f32(snr_t * ch_cfg.noise_w) / torch.clamp(gain2, min=_EPS)
    return _clip_power(p, pcfg)


def required_snr_for_rate(rate_target, blocklength, error_prob, *,
                          iters: int = 60, lo: float = 1e-9, hi: float = 1e14,
                          device: DeviceLike = None) -> torch.Tensor:
    """The minimum SNR whose FBL rate reaches ``rate_target`` (> 0).

    A fixed loop of ``iters`` float32 bisection steps in log-SNR space on
    the clipped ``channel.fbl_rate`` (non-decreasing in SNR), on the
    target's device (for a Python target, ``device``: None means CUDA,
    through ``resolve_device``); 60 steps resolve
    the [1e-9, 1e14] bracket far below the fading noise it feeds.
    Vectorized over ``rate_target``; no host round-trip.
    """
    target = torch.as_tensor(rate_target, dtype=torch.float32,
                             device=(rate_target.device
                                     if isinstance(rate_target, torch.Tensor)
                                     else resolve_device(device)))
    lo_t = torch.full(target.shape, math.log(lo), dtype=torch.float32,
                      device=target.device)
    hi_t = torch.full(target.shape, math.log(hi), dtype=torch.float32,
                      device=target.device)
    for _ in range(iters):
        mid = 0.5 * (lo_t + hi_t)
        ok = ch.fbl_rate(torch.exp(mid), blocklength, error_prob) >= target
        lo_t, hi_t = torch.where(ok, lo_t, mid), torch.where(ok, mid, hi_t)
    return torch.exp(hi_t)


@functools.lru_cache(maxsize=32)
def _required_snr_const(rate: float, blocklength: int, error_prob: float,
                        device: torch.device) -> torch.Tensor:
    """The required SNR of a config-constant target rate, computed once
    per device on that device, as XLA folds the reference's constant."""
    return required_snr_for_rate(rate, blocklength, error_prob, device=device)


def min_rate(config: Config, num_params: int) -> float:
    """The rate (bits/s/Hz) below which the d·n uplink cannot complete
    inside ``tau_limit_s``: a device at or under it is in outage and its
    packet drops w.p. 1 (``population.errors``)."""
    payload = float(num_params) * uplink_bits(config)
    return payload / (config.channel.bandwidth_hz * config.fl.tau_limit_s)


def deadline_rate(config: Config, num_params: int) -> float:
    """:func:`min_rate` padded by ``fbl_rate_margin`` — the rate
    ``fbl_target`` aims for, so it never sits on the latency cap."""
    return min_rate(config, num_params) * config.power.fbl_rate_margin


def fbl_target_power(config: Config, gain2: torch.Tensor,
                     num_params: int) -> torch.Tensor:
    """Minimum power meeting the configured FBL operating point in time."""
    pcfg, ch_cfg = config.power, config.channel
    snr_req = _required_snr_const(deadline_rate(config, num_params),
                                  ch_cfg.blocklength, ch_cfg.error_prob,
                                  gain2.device)
    p = snr_req * ch_cfg.noise_w / torch.clamp(gain2, min=_EPS)
    return _clip_power(p, pcfg)


def _power_grid(pcfg: PowerConfig, device: torch.device) -> torch.Tensor:
    """Log-spaced candidate powers [p_min, p_max] (G,), in float32."""
    lin = torch.linspace(math.log(pcfg.p_min), math.log(pcfg.p_max),
                         LYAPUNOV_GRID, dtype=torch.float32, device=device)
    return torch.exp(lin)


def battery_drift(battery_j: torch.Tensor,
                  capacity_j: torch.Tensor) -> torch.Tensor:
    """Normalized Lyapunov backlog: the deficit fraction
    (capacity − battery)/capacity, clipped to [DRIFT_FLOOR, 1]."""
    frac = (capacity_j - battery_j) / torch.clamp(capacity_j, min=_EPS)
    return torch.clamp(frac, DRIFT_FLOOR, 1.0)


def lyapunov_power(config: Config, gain2: torch.Tensor,
                   battery_j: torch.Tensor, capacity_j: torch.Tensor,
                   num_params: int) -> torch.Tensor:
    """Drift-plus-penalty grid search: argmax_p V·r̂(p) − drift·ê(p), the
    first maximum on a tie (``torch.argmax``, as ``jnp.argmax``).

    r̂/ê are each device's rate and capped uplink energy at every grid
    power, normalized by that device's max over the grid (scale-free).
    O(N·G) elementwise."""
    pcfg, ch_cfg = config.power, config.channel
    payload = _f32(float(num_params)) * uplink_bits(config)
    grid = _power_grid(pcfg, gain2.device)
    p = grid[:, None]                                            # (G, 1)
    rate = ch.fbl_rate(ch.snr(p, gain2[None, :], ch_cfg.noise_w),
                       ch_cfg.blocklength, ch_cfg.error_prob)    # (G, N)
    tau = payload / (ch_cfg.bandwidth_hz * torch.clamp(rate, min=1e-12))
    e = torch.clamp(tau, max=config.fl.tau_limit_s) * p          # (G, N)
    r_hat = rate / torch.clamp(rate.amax(0), min=_EPS)
    e_hat = e / torch.clamp(e.amax(0), min=_EPS)
    drift = battery_drift(battery_j, capacity_j)                 # (N,)
    score = pcfg.lyapunov_v * r_hat - drift[None, :] * e_hat
    return grid[score.argmax(0)]


def lyapunov_selection_score(battery_j: torch.Tensor, capacity_j: torch.Tensor,
                             rates: torch.Tensor, cost_j: torch.Tensor,
                             lyapunov_v: float) -> torch.Tensor:
    """The ``lyapunov`` selection score at the assigned operating point:
    V·(rate/mean rate) − drift·(cost/mean cost)."""
    r_hat = rates / torch.clamp(rates.mean(), min=_EPS)
    c_hat = cost_j / torch.clamp(cost_j.mean(), min=_EPS)
    return lyapunov_v * r_hat - battery_drift(battery_j, capacity_j) * c_hat


def assigned_power(config: Config, gain2: torch.Tensor,
                   battery_j: torch.Tensor, capacity_j: torch.Tensor,
                   num_params: int) -> torch.Tensor:
    """The round's per-device power vector (N,) under the configured
    policy: pure in (state, config)."""
    policy = config.power.policy
    if policy == "fixed":
        return torch.full(gain2.shape, fixed_power_w(config.power,
                                                     config.channel),
                          dtype=torch.float32, device=gain2.device)
    if policy == "channel_inversion":
        return channel_inversion_power(config.power, config.channel, gain2)
    if policy == "fbl_target":
        return fbl_target_power(config, gain2, num_params)
    if policy == "lyapunov":
        return lyapunov_power(config, gain2, battery_j, capacity_j, num_params)
    raise ValueError(f"unknown power.policy {policy!r}; "
                     f"expected one of {POLICIES}")


def calibrate_fixed_power(config: Config, *, num_params: int,
                          macs_per_iter: float, max_iters: int = 60,
                          seed: int = 0, device: DeviceLike = None,
                          gain2: torch.Tensor | None = None) -> Config:
    """Run the paper's CMA-ES joint (P_tx, q) optimization
    (``core.optimize``) at the bits the fleet ships and return a config
    whose ``power.p_fixed`` and ``channel.error_prob`` carry the optimum,
    so the ``fixed`` policy transmits at the §III eq. 20 operating point.
    ``device`` and ``gain2`` go to ``EnergyObjective``."""
    from repro_torch.core import optimize

    obj = optimize.EnergyObjective(config, num_params, macs_per_iter,
                                   seed=seed, device=device, gain2=gain2)
    res = optimize.optimize_power_and_error(
        obj, bits=float(uplink_bits(config)), max_iters=max_iters, seed=seed)
    p_tx, q = float(res.x_best[0]), float(res.x_best[1])
    return dataclasses.replace(
        config,
        power=dataclasses.replace(config.power, policy="fixed", p_fixed=p_tx),
        channel=dataclasses.replace(config.channel, error_prob=q))
