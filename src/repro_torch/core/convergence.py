"""FedAvg-with-packet-drops convergence machinery (paper §III, eq. 15-20).

Variance bound (eq. 16):
  E = Σ_k σ_k²/N² + 6LΓ + (8(I−1)² + 4(N−K)I²/(K(N−1)))·H² + 4dI²m²/(K(2ⁿ−1)²)

Drop-aware recursion (eq. 17):
  Δ_{t+1} ≤ (1 − η_t μ(1−q)) Δ_t + η_t² E/(1−q)

With η_t = β/(t+γ), β = 2/μ:
  v = max(4E/((1−q)μ²), (γ+1)Δ_1),  γ = max(I, 8L/((1−q)μ)) − 1
  Δ_t ≤ v/(t+γ),  E[f(w_T)] − f* ≤ (L/2)·v/(γ+T) ≤ ε
  ⇒ T = Lv/(2ε) − γ      (eq. 19-20)

Every function takes float32 tensors (0-dim, on any device) or Python
floats for ``bits`` and ``q``, and computes in float32 as the reference
does: the config constants combine in double on the host, then meet the
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.config.base import ConvergenceConfig, FLConfig


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def variance_bound_E(cfg: ConvergenceConfig, fl: FLConfig, *, num_params: int,
                     bits) -> torch.Tensor:
    """eq. 16. ``bits`` may be fractional (CMA-ES relaxes n continuously)."""
    N, K, I = fl.num_devices, fl.devices_per_round, fl.local_iters
    grad_noise = N * cfg.sigma_k2 / (N ** 2)          # Σ_k σ_k²/N² (homogeneous σ_k)
    hetero = 6.0 * cfg.L * cfg.gamma_noniid
    drift = (8.0 * (I - 1) ** 2 + 4.0 * (N - K) * I ** 2 / (K * (N - 1))) * cfg.H2
    levels = torch.clamp(2.0 ** _f32(bits) - 1.0, min=1.0)
    quant = 4.0 * num_params * I ** 2 * cfg.m ** 2 / (K * levels ** 2)
    return grad_noise + hetero + drift + quant


def gamma_param(cfg: ConvergenceConfig, fl: FLConfig, q) -> torch.Tensor:
    return torch.clamp(8.0 * cfg.L / ((1.0 - _f32(q)) * cfg.mu),
                       min=float(fl.local_iters)) - 1.0


def v_param(cfg: ConvergenceConfig, fl: FLConfig, *, E, q,
            rigorous: bool = False) -> torch.Tensor:
    """v such that Δ_t ≤ v/(t+γ).

    ``rigorous=False`` is the paper's v = max(4E/((1−q)μ²), (γ+1)Δ₁), which
    for q > 0 does not close the induction (tests/test_convergence_cmaes.py
    pins the violation); ``rigorous=True`` divides by the extra
    max(2(1−q)−1, 1e-3) factor and provably bounds the recursion (q < ½).
    """
    q = _f32(q)
    gamma = gamma_param(cfg, fl, q)
    floor = (gamma + 1.0) * cfg.delta1
    if rigorous:
        denom = (1.0 - q) * cfg.mu ** 2 * torch.clamp(2.0 * (1.0 - q) - 1.0,
                                                      min=1e-3)
        return torch.maximum(4.0 * _f32(E) / denom, floor)
    return torch.maximum(4.0 * _f32(E) / ((1.0 - q) * cfg.mu ** 2), floor)


def rounds_to_converge(cfg: ConvergenceConfig, fl: FLConfig, *, num_params: int,
                       bits, q, eps: float | None = None,
                       rigorous: bool = False) -> torch.Tensor:
    """T = Lv/(2ε) − γ (eq. 19-20), floored at 1 round."""
    eps = cfg.target_eps if eps is None else eps
    E = variance_bound_E(cfg, fl, num_params=num_params, bits=bits)
    v = v_param(cfg, fl, E=E, q=q, rigorous=rigorous)
    gamma = gamma_param(cfg, fl, q)
    return torch.clamp(cfg.L * v / (2.0 * eps) - gamma, min=1.0)


def bound_trajectory(cfg: ConvergenceConfig, fl: FLConfig, *, num_params: int,
                     bits: float, q: float, rounds: int) -> torch.Tensor:
    """Iterate the drop-aware recursion (eq. 17/18): the tests check that
    the closed form v/(t+γ) upper-bounds it."""
    E = variance_bound_E(cfg, fl, num_params=num_params, bits=bits)
    gamma = gamma_param(cfg, fl, q)
    beta = 2.0 / cfg.mu
    deltas = [cfg.delta1]
    d = _f32(cfg.delta1)
    for t in range(1, rounds):
        eta = beta / (t + gamma)
        d = (1.0 - eta * cfg.mu * (1.0 - q)) * d + eta ** 2 * E / (1.0 - q)
        deltas.append(float(d))
    return torch.tensor(deltas, dtype=torch.float32)
