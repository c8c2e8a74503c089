"""Joint (P_tx, q, n) energy optimization on the PyTorch port — paper §III
and the Fig. 2/4 pipeline, the same flow as
``examples/energy_optimization.py``.

Stage 1: CMA-ES over (P_tx, q) in [0.1,2]x[0.01,0.99] minimizing the
expected total energy (eq. 20) under the 1 s/round latency constraint.
Stage 2: sweep the standard FP formats {4,8,16,32} at the optimum.  The
objective runs on the CUDA device by default; ``--device cpu`` runs it on
the CPU.

  PYTHONPATH=src python examples/torch_energy_optimization.py [--iters 150] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.mnist_cnn import PAPER_MACS, PAPER_WEIGHTS
from repro_torch.core.optimize import joint_optimize


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device when omitted")
    args = ap.parse_args()

    cfg = get_config("mnist_cnn")
    print(f"optimizing (P_tx, q, n) for mnist_cnn: d={PAPER_WEIGHTS:,} params")
    res = joint_optimize(cfg, num_params=PAPER_WEIGHTS,
                         macs_per_iter=PAPER_MACS, max_iters=args.iters,
                         seed=0, verbose=True, device=args.device)

    print("\n=== CMA-ES optimum (paper Fig. 2) ===")
    print(f"P_tx* = {res.p_tx:.3f} W   (paper: ~0.1)")
    print(f"q*    = {res.q:.3f}       (paper: ~0.01)")
    print(f"CMA-ES iterations: {res.cmaes_result.iterations}, "
          f"converged: {res.cmaes_result.converged}")

    print("\n=== FP-format sweep at the optimum (paper Fig. 4) ===")
    print(f"{'format':>8} {'energy J':>12} {'tau_pr s':>10} {'T rounds':>9} "
          f"{'feasible':>9}")
    for n, m in sorted(res.per_bits.items()):
        print(f"{'FP'+str(n):>8} {m['energy_j']:12.2f} {m['tau_pr_s']:10.4f} "
              f"{m['rounds_T']:9.1f} {str(m['feasible']):>9}")
    e32 = res.per_bits[32]["energy_j"]
    print("\nsavings vs non-quantized (FP32):")
    for n in (4, 8, 16):
        print(f"  FP{n}: {1 - res.per_bits[n]['energy_j']/e32:7.2%}"
              + ("   <- paper claims 75.31% for FP8" if n == 8 else ""))
    print(f"\nselected n* = FP{res.bits} (min energy among feasible formats)")


if __name__ == "__main__":
    main()
