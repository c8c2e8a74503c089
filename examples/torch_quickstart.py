"""Quickstart on the PyTorch port: the paper's full loop through
``repro_torch``, the same flow as ``examples/quickstart.py``.

Federated training of the paper's QNN on synthetic digits with
stochastic-quantized local training and uplink, a finite-blocklength
channel at (P_tx=0.1 W, q=0.01), error-aware aggregation (eq. 6), and
per-round energy/latency accounting.  Runs on the CUDA device by default
(the hand-written kernels); ``--device cpu`` runs the kernels' plain
versions.

  PYTHONPATH=src python examples/torch_quickstart.py [--rounds 12] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.fl import FLSimulator
from repro_torch.data.pipeline import make_federated_digits
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--bits", type=int, default=8)
    ap.add_argument("--error-prob", type=float, default=0.01)
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device when omitted")
    args = ap.parse_args()

    cfg = get_config("mnist_cnn")
    cfg = dataclasses.replace(
        cfg,
        quant=dataclasses.replace(cfg.quant, bits=args.bits),
        channel=dataclasses.replace(cfg.channel, error_prob=args.error_prob,
                                    tx_power_w=0.1),
        fl=dataclasses.replace(cfg.fl, devices_per_round=5, local_iters=3,
                               learning_rate=0.05),
        train=dataclasses.replace(cfg.train, global_batch=32),
    )
    print(f"QNN: {cfg.model.name}; FP{args.bits or 32} quantization; "
          f"q={args.error_prob}; error-aware aggregation={cfg.fl.error_aware}")

    store = make_federated_digits(0, num_samples=3000, num_clients=20,
                                  iid=not args.non_iid, device=args.device)
    model = build_model(cfg)
    sim = FLSimulator(model, cfg, store, device=args.device)
    print(f"params: {sim.num_params:,} (paper: 421,642) on {sim.device}")

    params = convert.flatten_params(model.init(1, device=args.device))
    params, hist = sim.train(params, args.rounds, 2, log_every=2)

    total_e = sum(h["energy_j"] for h in hist)
    print(f"\nfinal train-batch accuracy: {hist[-1]['accuracy']:.3f}")
    print(f"total energy for {len(hist)} rounds: {total_e:.2f} J "
          f"(expected round energy {hist[0]['energy_j']:.2f} J, "
          f"round latency {hist[0]['tau_s']*1e3:.1f} ms)")


if __name__ == "__main__":
    main()
