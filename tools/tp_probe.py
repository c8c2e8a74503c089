"""The tensor-parallel distributed round alone on the card: the device
and build phases of ``chip_smoke.py``, then its ``tp_phase`` (4 workers
on cuda:0 over gloo with host staging; olmo-1b at full width cut in
depth, at (1, 4) and (2, 2) over ("data", "model"), reduced qwen2.5-14b
at (1, 4), granite-moe-1b-a400m at full width cut in depth at (1, 4),
reduced deepseek-v3-671b at (1, 2) and (1, 4) over ("pod", "model"),
whisper-base at (1, 4) with frames, rwkv6-7b and recurrentgemma-2b at
full width cut in depth at (1, 4), and reduced recurrentgemma-2b in
float32 at (1, 2); int, packed and rsag).  It prints the phase's JSON
lines, the card's name and power limit, and the launches a kernel.
Arch names as arguments keep only their jobs.

    PYTHONPATH=src python3 tools/tp_probe.py [ARCH ...]
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(archs) -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.launch.ranks import run_ranks

    if not torch.cuda.is_available():
        raise SystemExit("tp_probe: no CUDA device; it needs a card")
    if archs:
        chip_smoke.TP_JOBS = tuple(j for j in chip_smoke.TP_JOBS
                                   if j[0] in archs)
        if not chip_smoke.TP_JOBS:
            raise SystemExit(f"tp_probe: no job of {archs}")
    _, _, smi = chip_smoke.device_phase(torch)
    chip_smoke.build_phase(build)
    launches, err = chip_smoke.tp_phase(torch, run_ranks, smi)
    print(json.dumps({"launches_tp": launches, "max_abs_err": err,
                      "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
