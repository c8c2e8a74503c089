"""Joint (P_tx, q, n) energy optimization (paper §III, eq. 20).

    min_{n,P_tx,q}  (K/N)(Lv/2ε − γ) Σ_k (e^l(n) + e^u(n))
    s.t.            (K/N) Σ_k (d·n/(B·r_k) + MACs/C_comp · I) ≤ τ_limit

The continuous pair (P_tx, q) is optimized by CMA-ES (as in the paper);
the discrete bit-width n is then swept over the standard FP formats
{4, 8, 16, 32} at the optimal (P_tx*, q*) — the paper's two-stage
procedure.

The objective is evaluated in expectation over a fixed bank of Rayleigh
fading draws (common random numbers: smooth, CMA-ES friendly), on the
objective's device in float32; the search itself is numpy on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import Config
from repro_torch.core import channel as ch
from repro_torch.core import cmaes, convergence, energy
from repro_torch.device import DeviceLike, make_generator, resolve_device


class EnergyObjective:
    """Expected-total-energy objective with a latency penalty.

    ``gain2`` (num_fading_samples, N) is the bank of fading draws, one per
    (sample, device); without it the bank is drawn from a
    ``torch.Generator`` seeded with ``seed`` (the reference draws it from a
    jax key, which the port does not reproduce: pass the reference's bank
    to evaluate on the same draws).  ``device`` None means the CUDA device.
    """

    def __init__(self, config: Config, num_params: int, macs_per_iter: float,
                 num_fading_samples: int = 512, penalty: float = 1e4,
                 seed: int = 0, *, device: DeviceLike = None,
                 gain2: Optional[torch.Tensor] = None):
        self.config = config
        self.num_params = num_params
        self.macs_per_iter = macs_per_iter
        self.num_fading_samples = num_fading_samples
        self.penalty = penalty
        self.seed = seed
        self.device = resolve_device(device)
        shape = (num_fading_samples, config.fl.num_devices)
        if gain2 is None:
            gain2 = ch.sample_rayleigh_gain2(make_generator(seed, self.device),
                                             shape,
                                             config.channel.rayleigh_scale)
        if tuple(gain2.shape) != shape:
            raise ValueError(f"gain2 must be {shape}, got {tuple(gain2.shape)}")
        self.gain2 = gain2.to(self.device, torch.float32)

    def _scalar(self, x: float) -> torch.Tensor:
        return torch.full((), x, dtype=torch.float32, device=self.device)

    def _evaluate(self, p_tx: torch.Tensor, q: torch.Tensor,
                  bits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.config
        e_cfg, ch_cfg, fl, cv = cfg.energy, cfg.channel, cfg.fl, cfg.convergence
        rho = ch.snr(p_tx, self.gain2, ch_cfg.noise_w)
        rate = ch.fbl_rate(rho, ch_cfg.blocklength, q)          # (S, N)
        mean_rate = torch.clamp(rate.mean(0), min=1e-9)         # per-device E[r]
        T = convergence.rounds_to_converge(cv, fl, num_params=self.num_params,
                                           bits=bits, q=q)
        e_total = energy.expected_total_energy_j(
            e_cfg, ch_cfg, num_params=self.num_params, bits=bits,
            local_iters=fl.local_iters, rates_per_device=mean_rate,
            num_devices=fl.num_devices, devices_per_round=fl.devices_per_round,
            rounds=T, tx_power_w=p_tx)
        tau_pr = energy.round_time_s(
            e_cfg, ch_cfg, num_params=self.num_params, bits=bits,
            local_iters=fl.local_iters, macs_per_iter=self.macs_per_iter,
            rates_per_device=mean_rate, num_devices=fl.num_devices,
            devices_per_round=fl.devices_per_round)
        return e_total, tau_pr, T

    def evaluate(self, p_tx: float, q: float, bits: float) -> Dict[str, float]:
        e, tau, T = self._evaluate(self._scalar(p_tx), self._scalar(q),
                                   self._scalar(bits))
        e, tau, T = torch.stack([e, tau, T]).tolist()   # one read of the device
        return {"energy_j": e, "tau_pr_s": tau, "rounds_T": T}

    def penalized(self, p_tx: float, q: float, bits: float) -> float:
        m = self.evaluate(p_tx, q, bits)
        viol = max(0.0, m["tau_pr_s"] - self.config.fl.tau_limit_s)
        return m["energy_j"] + self.penalty * viol * viol


@dataclass
class JointOptResult:
    p_tx: float
    q: float
    bits: int
    energy_j: float
    tau_pr_s: float
    rounds_T: float
    cmaes_result: cmaes.CMAESResult
    per_bits: Dict[int, Dict[str, float]]


def optimize_power_and_error(obj: EnergyObjective, *, bits: float = 32.0,
                             x0: Optional[Tuple[float, float]] = None,
                             max_iters: int = 120, seed: int = 0,
                             verbose: bool = False) -> cmaes.CMAESResult:
    """CMA-ES over (P_tx, q) in the paper's box [0.1,2] x [0.01,0.99]."""
    lower = np.array([0.1, 0.01])
    upper = np.array([2.0, 0.99])
    x0 = np.array(x0 if x0 is not None else [1.0, 0.5])
    # the energy landscape is nearly flat in P_tx (uplink ~1% of total):
    # a tight ftol and long patience walk the last stretch to 0.1
    return cmaes.minimize(lambda x: obj.penalized(x[0], x[1], bits),
                          x0, 0.3, lower, upper, max_iters=max_iters,
                          seed=seed, ftol=1e-14, patience=60, verbose=verbose)


def joint_optimize(config: Config, *, num_params: int, macs_per_iter: float,
                   bit_candidates=(4, 8, 16, 32), max_iters: int = 120,
                   seed: int = 0, verbose: bool = False,
                   device: DeviceLike = None,
                   gain2: Optional[torch.Tensor] = None) -> JointOptResult:
    """Two-stage paper procedure: CMA-ES for (P_tx, q), then sweep FP
    formats.  ``device`` and ``gain2`` go to :class:`EnergyObjective`."""
    obj = EnergyObjective(config, num_params, macs_per_iter, seed=seed,
                          device=device, gain2=gain2)
    res = optimize_power_and_error(obj, max_iters=max_iters, seed=seed,
                                   verbose=verbose)
    p_tx, q = float(res.x_best[0]), float(res.x_best[1])

    per_bits: Dict[int, Dict[str, float]] = {}
    best_bits, best_e = None, np.inf
    for n in bit_candidates:
        m = obj.evaluate(p_tx, q, float(n))
        feasible = m["tau_pr_s"] <= config.fl.tau_limit_s
        per_bits[n] = dict(m, feasible=feasible)
        if feasible and m["energy_j"] < best_e:
            best_bits, best_e = n, m["energy_j"]
    if best_bits is None:  # nothing feasible: pick min energy anyway
        best_bits = min(per_bits, key=lambda n: per_bits[n]["energy_j"])
    m = per_bits[best_bits]
    return JointOptResult(p_tx, q, best_bits, m["energy_j"], m["tau_pr_s"],
                          m["rounds_T"], res, per_bits)
