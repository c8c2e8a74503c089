"""Device energy and latency model (paper §II-D, eq. 7/9/14).

Local training energy (eq. 7):   e^l(n) = β · C · f² · d_n · I,  d_n = d·n
Uplink energy (eq. 9):           e^u(n) = τ · P_tx,  τ = d^u·n / (B·r)
Expected total (eq. 14):         f_e(n) = (K·T/N) Σ_k (e^l + e^u)
Round latency:                   τ_pr = (K/N) Σ_k (τ_k^u + MACs/C_comp · I)
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ChannelConfig, EnergyConfig
from repro_torch.core import channel as ch


def local_training_energy_j(cfg: EnergyConfig, num_params: int, bits: int,
                            local_iters: int) -> torch.Tensor:
    """eq. 7 — energy of I local SGD iterations at n-bit precision."""
    d_n = torch.tensor(float(num_params), dtype=torch.float32) * max(bits, 1)
    return cfg.beta * cfg.cycles_per_bit * cfg.cpu_freq_hz ** 2 * d_n * local_iters


def uplink_time_s(ch_cfg: ChannelConfig, num_params: int, bits: int,
                  rate_bps_hz) -> torch.Tensor:
    payload = torch.tensor(float(num_params), dtype=torch.float32) * max(bits, 1)
    return ch.transmission_time_s(payload, ch_cfg.bandwidth_hz, rate_bps_hz)


def uplink_energy_j(ch_cfg: ChannelConfig, num_params: int, bits: int,
                    rate_bps_hz, tx_power_w=None) -> torch.Tensor:
    """eq. 9 — transmission energy at the achieved FBL rate; ``tx_power_w``
    (scalar or per-device) defaults to the config's P_tx."""
    p = ch_cfg.tx_power_w if tx_power_w is None else tx_power_w
    return uplink_time_s(ch_cfg, num_params, bits, rate_bps_hz) * p


def compute_time_s(cfg: EnergyConfig, macs_per_iter: float, local_iters: int) -> float:
    """MacOps/iteration / C_comp · I (paper §III)."""
    return float(macs_per_iter) / cfg.compute_capacity_flops * local_iters


def round_energy_j(e_cfg: EnergyConfig, ch_cfg: ChannelConfig, *, num_params: int,
                   bits: int, local_iters: int, rate_bps_hz,
                   tx_power_w=None) -> torch.Tensor:
    """Per-device energy for one round: e^l + e^u."""
    return (local_training_energy_j(e_cfg, num_params, bits, local_iters)
            + uplink_energy_j(ch_cfg, num_params, bits, rate_bps_hz, tx_power_w))


def expected_total_energy_j(e_cfg: EnergyConfig, ch_cfg: ChannelConfig, *,
                            num_params: int, bits: int, local_iters: int,
                            rates_per_device, num_devices: int,
                            devices_per_round: int, rounds: float,
                            tx_power_w=None) -> torch.Tensor:
    """eq. 14 — (K·T/N) Σ_k (e^l + e^u) with per-device achieved rates."""
    e_l = local_training_energy_j(e_cfg, num_params, bits, local_iters)
    e_u = uplink_energy_j(ch_cfg, num_params, bits, rates_per_device, tx_power_w)
    per_device = e_l.to(e_u.device) + e_u
    return devices_per_round / num_devices * rounds * per_device.sum()


def round_time_s(e_cfg: EnergyConfig, ch_cfg: ChannelConfig, *, num_params: int,
                 bits: int, local_iters: int, macs_per_iter: float,
                 rates_per_device, num_devices: int,
                 devices_per_round: int) -> torch.Tensor:
    """τ_pr = (K/N) Σ_k (τ_k^u + τ_k^comp) (paper §III)."""
    tau_u = uplink_time_s(ch_cfg, num_params, bits, rates_per_device)
    tau_c = compute_time_s(e_cfg, macs_per_iter, local_iters)
    return devices_per_round / num_devices * (tau_u + tau_c).sum()
