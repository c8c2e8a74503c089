"""How the L2 flush before a timed launch moves a one-pass kernel's time.

``chip_smoke.py`` times a single launch after writing 256 MB, which leaves
L2 full of dirty lines that are written back while the kernel runs.  This
probe times one ``repack`` ring hop at the ring's shape (10 rows of
105,411 words into 10 x 421,642 int32, lane 8) and a ``copy_`` of the same
33.7 MB of acc, each as the median of 50 single launches between two CUDA
events after each of two flushes: writing 256 MB (chip_smoke's ``ms``) and
reading them (L2 left clean).  It prints one JSON line per case with the
card's name and power limit.

Run from the repository root on a machine with a CUDA card:

    python3 tools/l2_probe.py
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def single_ms(torch, fn, flush, reps=50):
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        flush()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("l2_probe: no CUDA device; it needs a card")
    from repro_torch.core import quantization as quant
    from repro_torch.kernels import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0].strip()
    C, D = 10, 421_642
    gen = torch.Generator(device="cuda").manual_seed(11)
    codes = torch.randint(-128, 128, (C, D), generator=gen, device="cuda",
                          dtype=torch.int32)
    words = quant.pack_codes(codes, 8)
    acc, other = codes.clone(), codes.clone()
    buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    flushes = {"write": buf.zero_, "read": buf.sum}
    cases = {"repack_hop": lambda: ops.repack(words, acc, 8, D, hop=1),
             "copy_33_7MB": lambda: acc.copy_(other)}
    for name, fn in cases.items():
        print(json.dumps({"probe": name, **{
            f"ms_{k}_flush": single_ms(torch, fn, f) for k, f in flushes.items()},
            "ms_is": "median of 50 single launches after the flush",
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
