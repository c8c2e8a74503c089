"""Device energy and latency model (paper §II-D, eq. 7/9/14).

Local training energy (eq. 7):   e^l(n) = β · C · f² · d_n · I,  d_n = d·n
Uplink energy (eq. 9):           e^u(n) = τ · P_tx,  τ = d^u·n / (B·r)
Expected total (eq. 14):         f_e(n) = (K·T/N) Σ_k (e^l + e^u)
Round latency:                   τ_pr = (K/N) Σ_k (τ_k^u + MACs/C_comp · I)
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ChannelConfig, EnergyConfig
from repro_torch.core import channel as ch


def _at_least_one(bits):
    """max(bits, 1) of a Python number or a float32 tensor (CMA-ES relaxes
    n continuously)."""
    if isinstance(bits, torch.Tensor):
        return torch.clamp(bits, min=1.0)
    return max(bits, 1)


def _params(num_params: int) -> torch.Tensor:
    """float32(d) as a 0-dim CPU tensor, which ops on any device read as a
    scalar."""
    return torch.tensor(float(num_params), dtype=torch.float32)


def local_training_energy_j(cfg: EnergyConfig, num_params: int, bits,
                            local_iters: int) -> torch.Tensor:
    """eq. 7 — energy of I local SGD iterations at n-bit precision."""
    d_n = _params(num_params) * _at_least_one(bits)
    return cfg.beta * cfg.cycles_per_bit * cfg.cpu_freq_hz ** 2 * d_n * local_iters


def uplink_time_s(ch_cfg: ChannelConfig, num_params: int, bits,
                  rate_bps_hz, wire_bits_per_param: float | None = None
                  ) -> torch.Tensor:
    """τ = d·n/(B·r); ``wire_bits_per_param`` prices the payload at a
    realised collective's wire bits instead of the ideal n."""
    wire = bits if wire_bits_per_param is None else wire_bits_per_param
    payload = _params(num_params) * _at_least_one(wire)
    return ch.transmission_time_s(payload, ch_cfg.bandwidth_hz, rate_bps_hz)


def uplink_energy_j(ch_cfg: ChannelConfig, num_params: int, bits: int,
                    rate_bps_hz, tx_power_w=None) -> torch.Tensor:
    """eq. 9 — transmission energy at the achieved FBL rate; ``tx_power_w``
    (scalar or per-device) defaults to the config's P_tx."""
    p = ch_cfg.tx_power_w if tx_power_w is None else tx_power_w
    return uplink_time_s(ch_cfg, num_params, bits, rate_bps_hz) * p


def uplink_phase_energy_j(ch_cfg: ChannelConfig, num_params: int,
                          phase_bits_per_param: Dict[str, float],
                          rate_bps_hz, tx_power_w=None
                          ) -> Dict[str, torch.Tensor]:
    """eq. 9 itemized per collective phase (``aggregation``'s
    ``wire_phase_bits_per_param``, e.g. rsag's reduce_scatter and
    all_gather legs), each charged as its own transmission at the achieved
    rate with no 1-bit floor: the values sum to :func:`uplink_energy_j`
    at the summed wire bits whenever that clears the floor."""
    p = ch_cfg.tx_power_w if tx_power_w is None else tx_power_w
    out = {}
    for phase, bits in phase_bits_per_param.items():
        payload = _params(num_params) * bits
        tau = ch.transmission_time_s(payload, ch_cfg.bandwidth_hz, rate_bps_hz)
        out[phase] = tau * p
    return out


def capped_uplink_energy_j(ch_cfg: ChannelConfig, num_params: int, bits,
                           rate_bps_hz, tau_cap_s: float, tx_power_w=None,
                           wire_bits_per_param: float | None = None
                           ) -> torch.Tensor:
    """eq. 9 with the radio cut off at the round deadline: a device in a
    deep fade transmits until ``tau_cap_s`` and gives up, so it is charged
    at most ``tau_cap_s · P_i``, at its own assigned power (``tx_power_w``
    broadcasts per device).  The round cost the fleet battery debits."""
    p = ch_cfg.tx_power_w if tx_power_w is None else tx_power_w
    tau = uplink_time_s(ch_cfg, num_params, bits, rate_bps_hz,
                        wire_bits_per_param=wire_bits_per_param)
    return torch.clamp(tau, max=tau_cap_s) * p


def battery_debit_j(battery_j: torch.Tensor, device_idx: torch.Tensor,
                    cost_j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Debit per-device round costs from the fleet battery vector.

    ``device_idx`` (K,) holds distinct device ids, ``cost_j`` (K,) their
    round energies (zero for unfilled cohort slots).  The charge is clipped
    at the remaining battery, so cells never go negative; returns
    ``(new_battery_j, realized_charge_j)``, and the fleet's total energy
    falls by exactly the realized charge."""
    charge = torch.minimum(battery_j[device_idx], cost_j.float())
    return battery_j.index_add(0, device_idx, -charge), charge


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
