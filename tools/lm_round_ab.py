"""olmo-1b's cohort round at full width on one card, two checkouts
interleaved: ``chip_smoke.lm_round_phase`` of each checkout (its own
``src`` and its own ``chip_smoke.py``), one process a run, in the order
A, B, B, A, with ``LM_ROUNDS`` rounds a wire format in every run.

    python3 tools/lm_round_ab.py PARENT_CHECKOUT [--rounds 5]

A is PARENT_CHECKOUT (for example ``git archive <commit>`` unpacked under
``build/``), B this checkout.  Each run prints its ``lm_round`` lines to
``build/lm_round_ab/run_<i>.log``; the last lines give every run's
median round time and peak memory a format, and B's median over A's
(the mean of each side's two runs).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(root: Path, rounds: int) -> None:
    """One run: the checkout's chip_smoke and src, build, the phase."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config
    from repro_torch.core.fl import make_fl_round
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import build, ops
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build_model

    _, _, smi = cs.device_phase(torch)
    cs.build_phase(build)
    cs.LM_ROUNDS = rounds
    cs.lm_round_phase(torch, ops, get_config, apply_overrides, build_model,
                      token_batch, make_fl_round, tmesh, smi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one.resolve(), args.rounds)
        return 0
    out = ROOT / "build" / "lm_round_ab"
    out.mkdir(parents=True, exist_ok=True)
    runs = [("A", args.parent.resolve()), ("B", ROOT), ("B", ROOT),
            ("A", args.parent.resolve())]
    medians = {}
    for i, (side, root) in enumerate(runs, 1):
        log = out / f"run_{i}.log"
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, __file__, str(args.parent), "--rounds",
                 str(args.rounds), "--one", str(root)], stdout=f,
                stderr=subprocess.STDOUT, timeout=600).returncode
        lines = [json.loads(x) for x in log.read_text().splitlines()
                 if x.startswith('{"lm_round"')]
        print(json.dumps({"run": i, "side": side, "rc": rc, **{
            d["lm_round"]: [d["round_ms_median"], d["max_memory_allocated_gb"]]
            for d in lines}}))
        if rc:
            return rc
        for d in lines:
            medians.setdefault(d["lm_round"], {}).setdefault(side, []).append(
                d["round_ms_median"])
    print(json.dumps({"B_over_A": {
        mode: (sum(v["B"]) / len(v["B"])) / (sum(v["A"]) / len(v["A"]))
        for mode, v in medians.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
