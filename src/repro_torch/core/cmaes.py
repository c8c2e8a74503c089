"""CMA-ES from scratch (no ``cma`` package offline) — the port's own copy of
the reference's optimizer, step for step, so that both packages walk the
same search on the same objective values.

Standard (μ/μ_w, λ)-CMA-ES (Hansen 2016 tutorial): rank-one + rank-μ covariance
update and cumulative step-size adaptation, with box constraints handled by
resampling-free projection + quadratic boundary penalty.  The paper (§III)
uses CMA-ES to optimize (P_tx, q) under the per-round latency constraint;
``core.optimize`` builds that objective.

Pure numpy: the search space is 2-3 dims, so there is nothing to run on
the device here — the *objective* is the device part.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass
class CMAESResult:
    x_best: np.ndarray
    f_best: float
    history_x: np.ndarray       # (iters, dim) mean trajectory
    history_f: np.ndarray       # (iters,) best f per iteration
    history_sigma: np.ndarray
    iterations: int
    converged: bool


class CMAES:
    """Minimize ``f(x)`` over a box [lower, upper]."""

    def __init__(self, x0, sigma0: float, lower=None, upper=None, *,
                 popsize: Optional[int] = None, seed: int = 0,
                 boundary_penalty: float = 1e6):
        self.dim = len(x0)
        self.mean = np.asarray(x0, dtype=np.float64).copy()
        self.sigma = float(sigma0)
        self.lower = None if lower is None else np.asarray(lower, np.float64)
        self.upper = None if upper is None else np.asarray(upper, np.float64)
        self.rng = np.random.default_rng(seed)
        self.boundary_penalty = boundary_penalty

        n = self.dim
        self.lam = popsize or 4 + int(3 * np.log(n))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights ** 2)

        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mueff - 2 + 1 / self.mueff) / ((n + 2) ** 2 + self.mueff))
        self.damps = 1 + 2 * max(0.0, np.sqrt((self.mueff - 1) / (n + 1)) - 1) + self.cs
        self.chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n ** 2))

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.B = np.eye(n)
        self.D = np.ones(n)
        self.eigen_stale = 0

    # -- internals -----------------------------------------------------------

    def _update_eigen(self):
        self.C = (self.C + self.C.T) / 2
        d2, self.B = np.linalg.eigh(self.C)
        self.D = np.sqrt(np.maximum(d2, 1e-20))

    def _project(self, x: np.ndarray) -> np.ndarray:
        if self.lower is None and self.upper is None:
            return x
        return np.clip(x, self.lower, self.upper)

    def _penalized(self, f: Callable, x: np.ndarray) -> float:
        xf = self._project(x)
        pen = self.boundary_penalty * float(np.sum((x - xf) ** 2))
        return float(f(xf)) + pen

    # -- driver ---------------------------------------------------------------

    def optimize(self, f: Callable[[np.ndarray], float], *, max_iters: int = 200,
                 ftol: float = 1e-10, patience: int = 20,
                 verbose: bool = False) -> CMAESResult:
        hist_x, hist_f, hist_s = [], [], []
        best_x, best_f = self.mean.copy(), np.inf
        prev_best = np.inf
        stall = 0
        it = 0
        for it in range(1, max_iters + 1):
            z = self.rng.standard_normal((self.lam, self.dim))
            y = z @ (self.B * self.D).T            # B · diag(D) · z
            xs = self.mean + self.sigma * y
            fs = np.array([self._penalized(f, x) for x in xs])
            order = np.argsort(fs)
            xs, y, fs = xs[order], y[order], fs[order]

            if fs[0] < best_f:
                best_f, best_x = float(fs[0]), self._project(xs[0]).copy()

            y_w = self.weights @ y[: self.mu]
            self.mean = self.mean + self.sigma * y_w

            # CSA
            c_inv_half = self.B @ np.diag(1.0 / self.D) @ self.B.T
            self.ps = ((1 - self.cs) * self.ps
                       + np.sqrt(self.cs * (2 - self.cs) * self.mueff) * (c_inv_half @ y_w))
            hsig = (np.linalg.norm(self.ps)
                    / np.sqrt(1 - (1 - self.cs) ** (2 * it)) / self.chiN) < (1.4 + 2 / (self.dim + 1))
            self.pc = ((1 - self.cc) * self.pc
                       + hsig * np.sqrt(self.cc * (2 - self.cc) * self.mueff) * y_w)

            # covariance
            rank1 = np.outer(self.pc, self.pc)
            rankmu = sum(w * np.outer(yi, yi) for w, yi in zip(self.weights, y[: self.mu]))
            dh = (1 - hsig) * self.cc * (2 - self.cc)
            self.C = ((1 - self.c1 - self.cmu) * self.C
                      + self.c1 * (rank1 + dh * self.C)
                      + self.cmu * rankmu)
            self.sigma *= np.exp((self.cs / self.damps)
                                 * (np.linalg.norm(self.ps) / self.chiN - 1))
            self.sigma = float(np.clip(self.sigma, 1e-12, 1e6))

            self.eigen_stale += 1
            if self.eigen_stale > max(1, int(1 / (10 * (self.c1 + self.cmu) * self.dim))):
                self._update_eigen()
                self.eigen_stale = 0

            hist_x.append(self._project(self.mean).copy())
            hist_f.append(best_f)
            hist_s.append(self.sigma)
            if verbose and it % 10 == 0:
                print(f"  cmaes iter {it:4d}  f={best_f:.6g}  sigma={self.sigma:.3g}")

            if abs(prev_best - best_f) < ftol * (1 + abs(best_f)):
                stall += 1
                if stall >= patience:
                    break
            else:
                stall = 0
            prev_best = best_f

        return CMAESResult(best_x, best_f, np.array(hist_x), np.array(hist_f),
                           np.array(hist_s), it, stall >= patience)


def minimize(f, x0, sigma0, lower=None, upper=None, *, max_iters=200, seed=0,
             popsize=None, ftol=1e-10, patience=20, verbose=False) -> CMAESResult:
    return CMAES(x0, sigma0, lower, upper, popsize=popsize, seed=seed).optimize(
        f, max_iters=max_iters, ftol=ftol, patience=patience, verbose=verbose)
