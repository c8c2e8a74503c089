#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version, trains the paper's QNN for a few
rounds of Algorithm 1 through ``FLSimulator`` at the paper's widths
(N=100 clients, K=10 per round, I=3 local steps, batch 32, 8-bit, q=0.01),
checks that the round went through the kernels and agrees with the CPU
path on a small input, and times each kernel beside its plain version and
its bound.  Any failure raises and exits non-zero; the last line is the
JSON ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ROUNDS = 5
SHAPES = {"main": (10, 421_642), "ragged": (3, 5003)}
KERNELS = {
    "stochastic_quantize_codes": ("src/repro_torch/kernels/csrc/quantize.cu",
                                  "src/repro/kernels/quantize.py:38"),
    "dequantize_codes": ("src/repro_torch/kernels/csrc/quantize.cu",
                         "src/repro/kernels/quantize.py:75"),
    "masked_aggregate": ("src/repro_torch/kernels/csrc/aggregate.cu",
                         "src/repro/kernels/aggregate.py:28"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_phase(torch):
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {name}  count={count}  torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    return name, count, smi


def build_phase(build):
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(build.SOURCES)})")
    for src, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print(f"  {src}: {line.strip()}")
            elif "spill" in line:
                print(f"  {src}: {line.strip()}")


def kernels_phase(torch, ops, tref):
    """Each kernel against its plain version at the main and a ragged shape."""
    err = {k: 0.0 for k in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (K, D) in SHAPES.items():
        x = (torch.rand((K, D), generator=gen, device="cuda") - 0.5) * 3
        u = torch.rand((K, D), generator=gen, device="cuda")
        for bits in (1, 2, 4, 8):
            for clip in (1.0, 0.3):
                step = clip / 2 ** (bits - 1)
                edge = torch.tensor([clip, -clip, 0.0, 0.5 * step, -0.5 * step,
                                     1.5 * step, 2 * clip], device="cuda")
                x.view(-1)[:edge.numel()] = edge
                for stochastic in (True, False):
                    got = ops.stochastic_quantize_codes(x, u, bits, clip=clip,
                                                        stochastic=stochastic)
                    torch.cuda.synchronize()
                    want = tref.stochastic_quantize_ref(x, u, bits, clip=clip,
                                                        stochastic=stochastic)
                    err["stochastic_quantize_codes"] = max(
                        err["stochastic_quantize_codes"],
                        float((got - want).abs().max()))
                    check(torch.equal(got, want),
                          f"quantize differs: {label} bits={bits} clip={clip} "
                          f"stochastic={stochastic}")
                    deq = ops.dequantize_codes(got, bits, clip=clip)
                    torch.cuda.synchronize()
                    want = tref.dequantize_ref(got, bits, clip=clip)
                    err["dequantize_codes"] = max(err["dequantize_codes"],
                                                  float((deq - want).abs().max()))
                    check(torch.equal(deq, want),
                          f"dequantize differs: {label} bits={bits} clip={clip}")
        w = torch.rand(K, generator=gen, device="cuda") * 0.2
        w[0] = 0.0
        ints = torch.randint(-128, 128, (K, D), generator=gen, device="cuda",
                             dtype=torch.int32)
        cases = [(x * 0.01, w), (x * 0.01, torch.zeros_like(w)), (ints, w),
                 (x[:1].contiguous() * 0.01, w[1:2].contiguous())]
        for upd, wts in cases:
            got = ops.masked_aggregate(upd, wts)
            torch.cuda.synchronize()
            want = tref.masked_aggregate_ref(upd, wts)
            scale = max(1.0, float(upd.abs().max()))
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
            if float(wts.abs().sum()) == 0.0:
                check(bool((got == 0).all()), "all-zero weights must give 0")
            if upd.dtype == torch.float32:
                err["masked_aggregate"] = max(err["masked_aggregate"],
                                              float((got - want).abs().max()))
        print(f"kernels == plain at {label} shape (K={K}, D={D}): quantize "
              f"codes equal, dequantize equal, aggregate within rtol 1e-5 "
              f"atol 1e-6 (max abs err {err['masked_aggregate']:.3g})")
    return err


def paper_config(get_config, *, K=10, I=3, batch=32):
    cfg = get_config("mnist_cnn")
    return dataclasses.replace(
        cfg,
        quant=dataclasses.replace(cfg.quant, bits=8),
        channel=dataclasses.replace(cfg.channel, error_prob=0.01, tx_power_w=0.1),
        fl=dataclasses.replace(cfg.fl, num_devices=100, devices_per_round=K,
                               local_iters=I, learning_rate=0.05, error_aware=True),
        train=dataclasses.replace(cfg.train, global_batch=batch))


def main_path_phase(torch, ops, get_config, build_model, make_federated_digits,
                    FLSimulator, convert):
    cfg = paper_config(get_config)
    t0 = time.perf_counter()
    store = make_federated_digits(0, num_samples=20_000, num_clients=100)
    model = build_model(cfg)
    sim = FLSimulator(model, cfg, store)
    params = convert.flatten_params(model.init(1))
    torch.cuda.synchronize()
    print(f"set-up: {time.perf_counter() - t0:.2f} s (20,000 samples over 100 "
          f"clients on {sim.device}, {sim.num_params:,} parameters)")

    ops.reset_launch_counts()
    params, hist = sim.train(params, ROUNDS, 2)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)

    for h in hist:
        print(json.dumps({"round": h["round"], "loss": h["loss"],
                          "accuracy": h["accuracy"], "survivors": h["survivors"],
                          "round_s": h["round_s"], "energy_j": h["energy_j"],
                          "tau_s": h["tau_s"]}))
    losses = [h["loss"] for h in hist]
    check(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(bool(torch.isfinite(params).all()), "non-finite parameters")
    I, R = cfg.fl.local_iters, ROUNDS
    want = {"stochastic_quantize_codes": (I + 1) * R,
            "dequantize_codes": (I + 1) * R, "masked_aggregate": R}
    print(f"launches on the main path ({R} rounds): {launches}")
    check(launches == want, f"launch counts {launches} != predicted {want}")
    return launches, sim, params


def reference_phase(torch, get_config, build_model, FLSimulator, convert):
    """One small round on the card against the same round on the CPU."""
    K, I, B = 3, 2, 8
    cfg = paper_config(get_config, K=K, I=I, batch=B)
    cfg = dataclasses.replace(cfg, channel=dataclasses.replace(cfg.channel,
                                                               error_prob=0.3))
    gen = torch.Generator().manual_seed(7)
    model = build_model(cfg)
    params = convert.flatten_params(model.init(3, device="cpu"))
    D = params.numel()
    inputs = {"batches": {"images": torch.randn((K, I, B, 28, 28, 1), generator=gen),
                          "labels": torch.randint(0, 10, (K, I, B), generator=gen)},
              "u_train": torch.rand((K, I, D), generator=gen),
              "u_up": torch.rand((K, D), generator=gen),
              "lam": torch.tensor([1.0, 0.0, 1.0]),
              "alphas": torch.tensor([0.1, 0.25, 0.05])}

    class Store:
        def __init__(self, device):
            self.device = torch.device(device)

        def client_weights(self):
            return [0.1] * 10

    out = {}
    for dev in ("cpu", "cuda"):
        sim = FLSimulator(model, cfg, Store(dev), device=dev)
        b = {k: v.to(dev) for k, v in inputs["batches"].items()}
        kw = {k: inputs[k].to(dev) for k in ("u_train", "u_up")}
        deltas, _, _ = sim._client_update(params.to(dev), b, **kw)
        new, loss, _, _ = sim._round(params.to(dev), b, inputs["alphas"].to(dev),
                                     lam=inputs["lam"].to(dev), **kw)
        out[dev] = (deltas.cpu() * 128, new.cpu(), float(loss))
    diff = (out["cuda"][0] - out["cpu"][0]).abs()
    agree = float((diff == 0).float().mean())
    perr = (out["cuda"][1] - out["cpu"][1]).abs()
    print(f"card vs CPU, one round K={K} I={I} B={B}: uplink codes agree on "
          f"{agree:.6f}, max code diff {float(diff.max()):.0f}, max param diff "
          f"{float(perr.max()):.3g}, loss {out['cuda'][2]:.6f} vs {out['cpu'][2]:.6f}")
    check(float(diff.max()) <= 1 and agree >= 0.999, "uplink codes disagree")
    check(float(perr.max()) <= 1 / 128 and float((perr <= 1e-5).float().mean()) >= 0.999,
          "round parameters disagree with the CPU path")


def profile_phase(torch, sim, params, rounds=5):
    """Device busy share of a round.  The round time is the median host time
    of ``rounds`` unprofiled rounds, each ended by ``synchronize``; the
    device time by kernel comes from one more round under a CUDA-only
    ``torch.profiler`` trace (CUPTI), which adds no per-op host tracing."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    round_ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        sim.run_round(params, gen)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run_round(params, gen)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    median_ms = sorted(round_ms)[len(round_ms) // 2]
    print(json.dumps({"profile_round": {
        "round_ms_unprofiled": round_ms, "round_ms_median": median_ms,
        "round_ms_profiled": profiled_ms,
        "device_busy_ms": busy_ms if rows else None,
        "device_busy_share": busy_ms / median_ms if rows else None,
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for ms, n, k in rows[:12]]}}))


def time_ms(torch, fn, reps=50):
    """Median device time of ``fn`` with L2 flushed before each call."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timing_phase(torch, ops, tref, smi):
    K, D = SHAPES["main"]
    n = K * D
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.rand((K, D), generator=gen, device="cuda") - 0.5) * 0.02
    u = torch.rand((K, D), generator=gen, device="cuda")
    codes = ops.stochastic_quantize_codes(x, u, 8)
    w = torch.rand(K, generator=gen, device="cuda") * 0.1
    inv_gain = 1.0 / 128
    rows = {
        "stochastic_quantize_codes": (
            lambda: ops.stochastic_quantize_codes(x, u, 8),
            lambda: tref.stochastic_quantize_ref(x, u, 8), None,
            12.0 * n, 8.0 * n),
        "dequantize_codes": (
            lambda: ops.dequantize_codes(codes, 8),
            lambda: tref.dequantize_ref(codes, 8),
            lambda: torch.mul(codes, inv_gain), 8.0 * n, 1.0 * n),
        "masked_aggregate": (
            lambda: ops.masked_aggregate(x, w),
            lambda: tref.masked_aggregate_ref(x, w),
            lambda: (w @ x) / torch.clamp(w.sum(), min=1e-12),
            4.0 * n + 4.0 * D + 4.0 * K, 2.0 * n),
    }
    out = {}
    for name, (kernel, plain, library, nbytes, nops) in rows.items():
        b_ms, b_by = bound_ms(nbytes, nops)
        out[name] = {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
                     "library_ms": time_ms(torch, library) if library else None,
                     "bound_ms": b_ms, "bound_by": b_by}
        print(json.dumps({"timing": name, "shape": [K, D], **out[name],
                          "l2": "flushed before each launch", "card": smi}))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it needs a card")
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.core.fl import FLSimulator
    from repro_torch.data.pipeline import make_federated_digits
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as tref
    from repro_torch.models import build_model

    name, count, smi = device_phase(torch)
    build_phase(build)
    err = kernels_phase(torch, ops, tref)
    launches, sim, params = main_path_phase(torch, ops, get_config, build_model,
                                            make_federated_digits, FLSimulator,
                                            convert)
    profile_phase(torch, sim, params)
    reference_phase(torch, get_config, build_model, FLSimulator, convert)
    times = timing_phase(torch, ops, tref, smi)
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": err[k], **times[k]}
               for k, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
