"""Finite-blocklength uplink channel (paper §II-D2).

Achievable rate under blocklength M and target error probability q
(Polyanskiy et al. 2010, eq. 8 of the paper):

    r(ρ|h|², M, q) ≈ C(ρ|h|²) − sqrt(V(ρ|h|²)/M) · Q⁻¹(q)
    C(x) = log2(1+x)
    V(x) = (1 − (1+x)⁻²) · (log2 e)²

The channel is quasi-static Rayleigh: |h|² ~ Exp(1/scale), constant over the
M-symbol block; full CSI, rate adaptation, so q is a *chosen* operating point
(the packet drop probability in the aggregation model).  All maths is
float32 torch; the samplers draw from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def qfunc_inv(q) -> torch.Tensor:
    """Inverse Gaussian Q-function via erfinv: Q⁻¹(q) = sqrt(2)·erfinv(1−2q)."""
    q = _f32(q)
    return math.sqrt(2.0) * torch.special.erfinv(1.0 - 2.0 * q)


def capacity(snr) -> torch.Tensor:
    return torch.log2(1.0 + _f32(snr))


def dispersion(snr) -> torch.Tensor:
    return (1.0 - (1.0 + _f32(snr)) ** -2) * LOG2E ** 2


def fbl_rate(snr, blocklength, error_prob) -> torch.Tensor:
    """Achievable rate (bits/s/Hz), clipped at 0 (deep fades -> outage).

    Vectorized over broadcastable ``snr``; the dispersion is floored inside
    the sqrt so gradients stay finite as snr -> 0.
    """
    snr = _f32(snr)
    v = torch.clamp(dispersion(snr), min=1e-12)
    # a Python error_prob gives a 0-dim CPU tensor, which a CUDA op reads as
    # a scalar: no copy to the device and no wait for it
    r = capacity(snr) - torch.sqrt(v / blocklength) * qfunc_inv(error_prob)
    return torch.clamp(r, min=0.0)


def snr(tx_power_w, channel_gain2, noise_w) -> torch.Tensor:
    """ρ = P·|h|²/N₀ — every argument broadcasts."""
    return tx_power_w * _f32(channel_gain2) / noise_w


def sample_rayleigh_gain2(gen: torch.Generator, shape=(),
                          scale: float = 1.0) -> torch.Tensor:
    """|h|² for Rayleigh fading is exponential with mean ``scale``."""
    e = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return e.exponential_(generator=gen) * scale


def _std(scale) -> torch.Tensor:
    return torch.sqrt(_f32(scale) / 2.0)


def init_rayleigh_state(gen: torch.Generator | None, shape, scale=1.0, *,
                        normals=None) -> tuple:
    """Stationary complex Rayleigh fading state h ~ CN(0, scale).

    Returns ``(h_re, h_im)``, each component N(0, scale/2), so
    ``h_re² + h_im²`` is exponential with mean ``scale``; ``scale``
    broadcasts (a per-device pathloss vector).  ``normals`` = (z_re, z_im),
    standard normals of ``shape``, replaces the draws from ``gen``.
    """
    z_re, z_im = normals if normals is not None else _normal_pair(gen, shape)
    std = _std(scale)
    return z_re * std, z_im * std


def gauss_markov_fading_step(gen: torch.Generator | None, h_re: torch.Tensor,
                             h_im: torch.Tensor, rho: float, scale=1.0, *,
                             normals=None) -> tuple:
    """One AR(1) Gauss-Markov step of the complex fading state.

        h_{t+1} = ρ·h_t + sqrt(1-ρ²)·w,   w ~ CN(0, scale)

    The stationary distribution is preserved (|h|² stays Exp(scale)) and
    the per-component lag-1 autocorrelation is ρ; ρ=0 recovers the i.i.d.
    per-round draw.  The reference's order: w = normal·std, then
    ρ·h + c·w, c = float32(sqrt(max(1-ρ², 0))).  ``normals`` = (z_re, z_im)
    replaces the draws from ``gen``.
    """
    z_re, z_im = (normals if normals is not None
                  else _normal_pair(gen, h_re.shape))
    std = _std(scale)
    c = torch.sqrt(_f32(max(1.0 - rho * rho, 0.0)))
    w_re, w_im = z_re * std, z_im * std
    return rho * h_re + c * w_re, rho * h_im + c * w_im


def _normal_pair(gen: torch.Generator | None, shape) -> tuple:
    if gen is None:
        raise ValueError("pass a generator, or the normals")
    return (torch.randn(shape, generator=gen, device=gen.device),
            torch.randn(shape, generator=gen, device=gen.device))


def transmission_time_s(payload_bits, bandwidth_hz, rate_bps_hz) -> torch.Tensor:
    """τ = d·n / (B·r); infinite (outage) when r == 0."""
    rate = torch.clamp(_f32(rate_bps_hz), min=1e-12)
    return payload_bits / (bandwidth_hz * rate)


def expected_rate(cfg, gen: torch.Generator | None, num_samples: int = 4096,
                  *, gain2: torch.Tensor | None = None) -> torch.Tensor:
    """Monte-Carlo E[r] over Rayleigh fading at the configured operating
    point; ``gain2`` (num_samples,) replaces the draws from ``gen``."""
    g2 = (gain2 if gain2 is not None
          else sample_rayleigh_gain2(gen, (num_samples,), cfg.rayleigh_scale))
    r = fbl_rate(snr(cfg.tx_power_w, g2, cfg.noise_w), cfg.blocklength,
                 cfg.error_prob)
    return r.mean()


def sample_packet_success(gen: torch.Generator, shape,
                          error_prob: float) -> torch.Tensor:
    """λ_k reliability factors: 1 w.p. 1-q, 0 w.p. q (paper §II-C1)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (u >= error_prob).float()
