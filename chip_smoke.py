#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version, and drives the port's two paths
through the kernels at the paper's widths:

* Algorithm 1 through ``FLSimulator`` (N=100 clients, K=10 per round, I=3
  local steps, batch 32, 8-bit, q=0.01);
* the cohort round ``make_fl_round`` on the same QNN over C=10 cohorts
  (I=3, 32 images per microbatch): on one axis (10,) in the paper, int,
  packed, ring, rsag (ring and rsag with both front-ends) and auto wire
  formats, and on two axes (2, 5) ("pod", "data") in int, packed, ring,
  rsag and auto;
* the int8 product ``kernels.ops.qmatmul``, whose entry point is the
  kernel API itself (no round calls it), at the shapes it is given;
* the fleet (``population``): ``FLSimulator`` over a 10^6-device fleet,
  5 rounds each of rate_aware selection with fbl_target power (eq. 6)
  and of lyapunov selection with lyapunov power and the unbiased IPW
  aggregate (``masked_aggregate`` with a denominator); the cohort round
  with a 10^5-device fleet and the IPW scale at (10,) and (2, 5) in int,
  packed, ring and rsag; ``round_update`` alone at 10^6 devices, which
  must make no synchronizing call;
* the paper's §III planner: ``joint_optimize`` on the card against the
  paper's trends, and the four power policies over 100 rounds of the
  population layer at 10^5 devices, ``fixed`` seeded by
  ``calibrate_fixed_power``, against the ordering the reference's
  ``benchmarks/power_policies.py`` gates;
* the dense LM: olmo-1b at full width (D = 1,176,764,416 bfloat16)
  through the cohort round on the reference's 8-device (2, 4) mesh, C = 2
  cohorts stacked, I = 3, 12 sequences of 512 tokens a round, in the
  paper, int, packed, ring, rsag and auto wire formats; the uplink's
  kernels on its (2, D) operands, past flat index 2^31, on windows held
  to their plain versions; a reduced float32 LM round against the CPU;
  and the trainer ``repro_torch.launch.train.main`` for 2 steps;
* the float32 local step ``kernels.ops.fma_step_`` (``csrc/sgd.cu``, one
  fused multiply-add an element, as XLA contracts the reference's
  ``w - eta * g``), held to ``fma32`` and launched I times a QNN round;
* checkpoints and streamed telemetry: the trainer on olmo-1b at full width
  with a 10^5-device fleet saves after step 1 and resumes for step 2
  (``--checkpoint-dir``, ``--telemetry-dir``), held to a replay; the
  simulator over the 10^6-device fleet with the tap on and off; the
  ``wire/*``, ``fleet/*`` and ``fl/*`` spans of a profiled cohort fleet
  round in each format;
* a dtype per leaf (``convert.Layout``: a bfloat16 and a float32 buffer)
  and the MoE: granite-moe-1b-a400m at full width (D = 1,384,963,072,
  its norm scales and router float32) through the cohort round at
  olmo-1b's cut in every wire format, its uplink kernels on (2, D)
  windows past 2^31, ``fma_step`` on its float32 leaves held to
  ``fma32``, the trainer with a checkpoint restored equal, and the
  server; reduced against the CPU, its round in float32 and bfloat16
  (beside reduced bfloat16 qwen2.5-14b's: the mixed layout), the mixed
  layout's step, delta and apply and its serving in float32; qwen2.5-14b (D = 14,770,033,664) served at full width at the
  CLI's defaults and at a 16,384-token prompt with 64 decode steps, and
  reduced in float32 against the CPU; yi-9b served at full width;
* the recurrent families: rwkv6-7b (RWKV-6, D = 7,576,756,224) and
  recurrentgemma-2b (the Griffin hybrid, D = 3,549,934,080) served at full
  width through ``launch.serve.main`` at the CLI's defaults and natively
  on long_500k (batch 1, a 4,096- and a 16,384-token prompt, 64 decode
  steps under sync debug "error", a state cache of the same bytes at any
  context), reduced float32 serving against the CPU (the hybrid at 3
  layers, a local-attention layer in it); each through the cohort round
  at a depth cut (3 and 1 layers) in every wire format, its uplink
  kernels on (2, D) windows, the trainer for 2 rsag steps and a reduced
  float32 round against the CPU in int and rsag;
* serving: olmo-1b at full width through ``launch.serve.main`` at the
  reference CLI's defaults with a telemetry stream, at prefill_32k's and
  decode_32k's context (batch 2, a 32,704-token prompt, a 32,768 cache,
  64 greedy decode steps), and in long_500k's 8,192-token window ring
  (batch 1, a 16,384-token prompt, 64 steps), the decode steps under
  ``torch.cuda.set_sync_debug_mode("error")``, each time beside the
  analytic bound of ``utils.flops`` on ``utils.roofline``; and a reduced
  float32 olmo-1b prefill and decode on the card against the CPU;
* the rest of the zoo: whisper-base (the encoder-decoder, D =
  97,182,720) served at full width (the CLI's defaults with 1,500 frames
  of 512; 8 × 32,704 tokens into a 32,768 cache, 64 steps) and through
  the cohort round at C = 2, I = 3, 12 × 448 tokens with their frames in
  every format, its uplink kernels held whole to their plain versions,
  ``fma_step`` on its float32 layernorms, the trainer's refusal;
  deepseek-v3-671b (MLA, a shared expert, MTP) at full width and 1 of 61
  layers and chameleon-34b (vlm) at full width and depth, served at the
  CLI's defaults and at a 16,384-token prompt with 64 decode steps; the
  three reduced against the CPU: serving, float32 rounds in every format
  and deepseek's and chameleon's rounds in bfloat16;
* one cohort a process (``make_dist_fl_round`` over ``core.comm``): 4
  worker processes (``spawn``) share the card over gloo, each payload
  staged through pinned host memory, and run the QNN at the paper's width
  at (4,), (2, 2) ("pod", "data") and (2, 2) ("data", "model") in the
  paper, int, packed, ring and rsag formats (both front-ends), 3 rounds
  each; then 2 workers run reduced olmo-1b and qwen2.5-14b in bfloat16
  at (2,) in ring and rsag.  Replicas ``torch.equal`` after every round,
  the quantized formats ``torch.equal`` to each other, the per-rank
  aggregate against the stacked one on the stacked round's rows, the
  round against the stacked round on the same draws; round and staging
  ms beside the card;
* tensor parallelism over "model" (``sharding.placement``): 4 workers
  over gloo again run olmo-1b at full width, cut to 4 of its 16 layers,
  at (1, 4) and (2, 2) over ("data", "model"), and reduced qwen2.5-14b
  with its biases at (1, 4), in int, packed and rsag, 2 rounds each:
  each rank's parameter bytes against ``sharding.bytes_per_device``, its
  peak beside the stacked round's, round and staging ms, the first
  round's gathered parameters against the stacked round on the same
  draws, every wire kernel against its plain version at (1, D_local).

For each path it checks the launch counts, that the round agrees with the
CPU path on a small input, and times the rounds; then it times each kernel
beside its plain version and its bound.  Any failure raises and exits
non-zero; the last line is the JSON ``{"ok": true, "device": ...}``.
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
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
SHORT_BOUND_MS = 5e-3         # below this bound the plain version is also timed back to back
ROUNDS = 5
COHORT_ROUNDS = 3
SHAPES = {"main": (10, 421_642), "ragged": (3, 5003)}
PACK_SRC = "src/repro_torch/kernels/csrc/pack.cu"
KERNELS = {
    "stochastic_quantize_codes": ("src/repro_torch/kernels/csrc/quantize.cu",
                                  "src/repro/kernels/quantize.py:38"),
    "dequantize_codes": ("src/repro_torch/kernels/csrc/quantize.cu",
                         "src/repro/kernels/quantize.py:75"),
    "masked_aggregate": ("src/repro_torch/kernels/csrc/aggregate.cu",
                         "src/repro/kernels/aggregate.py:28"),
    # the same kernel with a given divisor: the fleet's IPW aggregate
    # (src/repro/population/errors.py:90), eq. 6's Pallas kernel's chain
    "masked_aggregate_den": ("src/repro_torch/kernels/csrc/aggregate.cu",
                             "src/repro/kernels/aggregate.py:28"),
    "quantize_pack": (PACK_SRC, "src/repro/kernels/pack.py:76"),
    "unpack_dequantize": (PACK_SRC, "src/repro/kernels/pack.py:134"),
    "quantize_pack_chunk": (PACK_SRC, "src/repro/kernels/pack.py:273"),
    "repack": (PACK_SRC, "src/repro/kernels/pack.py:192"),
    "pack_sums": (PACK_SRC, "src/repro/kernels/pack.py:368"),
    "qmatmul": ("src/repro_torch/kernels/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul.py:35"),
    # replaces no Pallas kernel: a third entry says what it replaces
    "fma_step": ("src/repro_torch/kernels/csrc/sgd.cu", None,
                 "no Pallas counterpart: XLA's fused w - eta*g "
                 "(src/repro/core/fl.py:185, :620, "
                 "src/repro/launch/steps.py:31)"),
}
#: the cohort round's layouts and modes: (label, collective, pipeline_hops)
COHORT_MODES = {
    (10,): (("paper", "paper", True), ("int", "int", True),
            ("packed", "packed", True), ("ring", "ring", True),
            ("ring_sequential", "ring", False), ("rsag", "rsag", True),
            ("rsag_sequential", "rsag", False), ("auto", "auto", True)),
    (2, 5): (("int", "int", True), ("packed", "packed", True),
             ("ring", "ring", True), ("ring_sequential", "ring", False),
             ("rsag", "rsag", True), ("rsag_sequential", "rsag", False),
             ("auto", "auto", True)),
}
#: wire bits/param each layout's plan must price (8 bits)
COHORT_WIRE_BITS = {(10,): {"paper": 32.0, "int": 16.0, "packed": 16.0,
                            "ring": 72.0, "rsag": 26.4, "auto": 16.0},
                    (2, 5): {"int": 16.0, "packed": 16.0, "ring": 152.0 / 3,
                             "rsag": 32.8, "auto": 16.0}}
#: qmatmul's shapes (M, K, N): kernels_micro's, the QNN's fc1 at the
#: cohort round's 960 images, the exactness case of tests/test_kernels.py
QMATMUL_SHAPES = ((256, 512, 256), (960, 3136, 128), (8, 4096, 8))
#: qmatmul's edge inputs (M, K, N, byte offset of x and w in their buffers,
#: fill): K and N not multiples of 16 (byte staging), a single element,
#: M < 16 on the 16-byte staging, contiguous slices whose data_ptr() is 1
#: or 8 bytes past an aligned one (byte staging of a shape otherwise staged
#: 16 bytes at a time), and the all -128 sum of 67,108,864 at K = 4096
QMATMUL_EDGES = ((33, 4099, 17, 0, None), (1, 5, 1, 0, None),
                 (12, 96, 48, 0, None), (100, 3136, 128, 1, None),
                 (100, 3136, 128, 8, None), (8, 4096, 8, 0, -128))
#: the quantizer's flat sizes (every head and tail of its 16-byte path) and
#: the byte offsets (x, u) of its views past a 16-byte boundary: equal
#: offsets keep the 16-byte path, different ones take the scalar kernel
QUANTIZER_SIZES = (1, 3, 4, 5, 7, 4099)
QUANTIZER_OFFSETS = ((4, 4), (8, 8), (12, 12), (4, 8), (0, 12), (12, 4))
#: quantize_pack and quantize_pack_chunk's (bits, lane) cases: each of the
#: ten codes-per-word counts of lanes 1-32 at the widest bits that fit (at
#: most 8), the packed psum's lane 12, and 16 and 24 bits at lanes 16-32,
#: where a step is a few ulp of the scaled value (ROADMAP C1)
WIRE_QUANT_CASES = tuple((min(lane, 8), lane) for lane in
                         (32, 16, 10, 8, 6, 5, 4, 3, 2, 1)) + (
    (8, 12), (16, 16), (16, 24), (16, 32), (24, 24), (24, 28), (24, 32))
#: words a thread of those kernels owns, by codes per word (pack.cu kWords)
WIRE_QUANT_WORDS = {32: 1, 16: 1, 10: 1, 8: 1, 6: 2, 5: 2, 4: 2, 3: 3, 2: 4,
                    1: 8}
#: words a thread of pack_sums and of unpack_dequantize owns, by codes per
#: word (pack.cu kSumWords, kUnpackWords)
SUM_WORDS = {32: 1, 16: 1, 10: 2, 8: 2, 6: 3, 5: 4, 4: 4, 3: 6, 2: 8, 1: 16}
UNPACK_WORDS = {32: 1, 16: 1, 10: 1, 8: 1, 6: 2, 5: 2, 4: 2, 3: 3, 2: 4, 1: 8}
#: the one PyTorch call timed beside a kernel (library_ms), where one exists
LIBRARY_CALLS = {"dequantize_codes": "torch.mul",
                 "masked_aggregate": "w @ x / sum(w)",
                 "masked_aggregate_den": "w @ x / den",
                 "qmatmul": "torch._int_mm (int32, no scaling), the faster of "
                            "w row-major and w column-major",
                 "fma_step": "w.sub_(g, alpha=eta), counted only where it "
                             "rounds once on the card (sub_alpha_rounds_once)"}
#: the wire phases each format's aggregate spans (as the reference's do)
WIRE_SPANS = {"int": ("wire/psum", "wire/quantize_pack", "wire/unpack_dequant"),
              "ring": ("wire/psum", "wire/quantize_pack", "wire/ring_hops",
                       "wire/unpack_dequant"),
              "rsag": ("wire/psum", "wire/quantize_pack", "wire/reduce_scatter",
                       "wire/all_gather", "wire/unpack_dequant")}
WIRE_SPANS["packed"] = WIRE_SPANS["int"]


#: the fleet paths: FLSimulator over FLEET_SIZE devices in (selection,
#: power policy, error_reweight) runs, the cohort round over
#: COHORT_FLEET_SIZE devices in each wire format of COHORT_FLEET_MODES,
#: and the power-policy check of the population layer alone
FLEET_SIZE = 1_000_000
FLEET_SIM_RUNS = (("rate_aware", "fbl_target", False),
                  ("lyapunov", "lyapunov", True))
COHORT_FLEET_SIZE = 100_000
COHORT_FLEET_MODES = ("int", "packed", "ring", "rsag")
POWER_CHECK = {"size": 100_000, "rounds": 100, "cohort": 64,
               "noise_psd_dbm": 0.0, "outage_tol": 0.02, "cmaes_iters": 40}


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


def _edge_values(torch, bits, clip):
    """±clip, 0, half steps, 1.5 steps and 2·clip: the quantizer's edges."""
    step = clip / 2 ** (bits - 1)
    return torch.tensor([clip, -clip, 0.0, 0.5 * step, -0.5 * step,
                         1.5 * step, 2 * clip], device="cuda")


def kernels_phase(torch, ops, tref):
    """Each kernel against its plain version at the main and a ragged shape."""
    err = {k: 0.0 for k in ("stochastic_quantize_codes", "dequantize_codes",
                            "masked_aggregate", "masked_aggregate_den")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (K, D) in SHAPES.items():
        x = (torch.rand((K, D), generator=gen, device="cuda") - 0.5) * 3
        u = torch.rand((K, D), generator=gen, device="cuda")
        for bits in (1, 2, 4, 8, 24):
            for clip in (1.0, 0.3):
                x.view(-1)[:7] = _edge_values(torch, bits, clip)
                for stochastic in (True, False):
                    noise = u if stochastic else None
                    got = ops.stochastic_quantize_codes(x, noise, bits, clip=clip,
                                                        stochastic=stochastic)
                    torch.cuda.synchronize()
                    want = tref.stochastic_quantize_ref(x, noise, bits, clip=clip,
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
            err["masked_aggregate"] = max(err["masked_aggregate"],
                                          _max_diff(got, want))
            check(torch.equal(got, want),
                  f"aggregate differs: {label} {upd.dtype} K={upd.shape[0]}")
            if float(wts.abs().sum()) == 0.0:
                check(bool((got == 0).all()), "all-zero weights must give 0")
            den = wts.sum() * 0.75 + 0.01          # a divisor on the card
            got = ops.masked_aggregate(upd, wts, den=den)
            torch.cuda.synchronize()
            want = tref.masked_aggregate_ref(upd, wts, den=den)
            err["masked_aggregate_den"] = max(err["masked_aggregate_den"],
                                              _max_diff(got, want))
            check(torch.equal(got, want),
                  f"aggregate with den differs: {label} {upd.dtype} "
                  f"K={upd.shape[0]}")
        print(f"kernels == plain (torch.equal) at {label} shape (K={K}, D={D}): "
              f"quantize, dequantize, aggregate with and without a "
              f"denominator (f32 and int32 updates, all-zero weights, K=1)")
    return err


def roadmap_c5_input(torch):
    """ROADMAP C5's input on the card: 200,000 weights N(0, 0.05^2) and
    gradients N(0, 1) from ``numpy.random.default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    w = (rng.standard_normal(200_000) * 0.05).astype(np.float32)
    g = rng.standard_normal(200_000).astype(np.float32)
    return torch.from_numpy(w).cuda(), torch.from_numpy(g).cuda()


def sgd_phase(torch, ops, tref):
    """The float32 SGD step (``csrc/sgd.cu``) against its plain version
    ``fma32`` (w - eta*g rounded once), ``torch.equal``: at the QNN's
    (10, 421,642) on its 16-byte path, on ROADMAP C5's input (eta 0.001:
    a mul and a sub differ from the exact step at 6,028 weights), on a leaf of
    a (K, D) parameter block (strided rows, the element path) and on a view
    4 bytes off a boundary; the plans checked.  Also whether
    ``w.sub_(g, alpha=eta)`` rounds once on the card (equal to ``fma32``
    on the same inputs).  Returns (max abs error, that answer)."""
    eta = float(torch.tensor(0.05, dtype=torch.float32))
    eta_c5 = float(torch.tensor(0.001, dtype=torch.float32))    # ROADMAP C5's
    gen = torch.Generator(device="cuda").manual_seed(5)
    K, D = SHAPES["main"]
    block = torch.randn((K, D), generator=gen, device="cuda") * 0.05
    w0, g0 = roadmap_c5_input(torch)
    cases = {"main": (block.clone(), torch.randn((K, D), generator=gen,
                                                 device="cuda"), True),
             "roadmap_c5": (w0.clone(), g0, True),
             "leaf_of_(K,D)": (block.clone()[:, 1000:5096].view(K, 64, 64),
                               torch.randn((K, 64, 64), generator=gen,
                                           device="cuda"), False),
             "view_4_bytes_off": (block.clone().view(-1)[1:100_001],
                                  torch.randn(100_000, generator=gen,
                                              device="cuda"), False)}
    err, sub_once = 0.0, True
    for label, (w, g, vector) in cases.items():
        e = eta_c5 if label == "roadmap_c5" else eta
        want = tref.fma32(torch.tensor(-e, device="cuda"), g, w)
        sub_once &= torch.equal(w.clone().sub_(g, alpha=e), want)
        plan = ops.fma_step_plan(w, g)
        check(plan.vector == vector, f"fma_step {label}: plan {plan}")
        before = ops.LAUNCHES["fma_step"]
        ops.fma_step_(w, g, e)
        torch.cuda.synchronize()
        check(ops.LAUNCHES["fma_step"] == before + 1, f"fma_step {label}: launch")
        err = max(err, _max_diff(w, want))
        check(torch.equal(w, want), f"fma_step {label} differs from fma32")
    two = w0 - eta_c5 * g0
    print(json.dumps({"fma_step": "torch.equal to fma32",
                      "cases": list(cases), "roadmap_c5_two_roundings_differ":
                      int((two != tref.fma32(torch.tensor(-eta_c5, device="cuda"),
                                             g0, w0)).sum()),
                      "sub_alpha_rounds_once": bool(sub_once)}))
    return err, bool(sub_once)


#: masked_aggregate's cases beyond the main shapes (K, D, byte offset of
#: the updates past a 16-byte boundary): every K specialisation (1-16) and
#: the generic kernel (K 17, 20 and 33: one, two and three steps of 16
#: rows) at D odd (4-byte loads), D = 2 mod 4 (8-byte) and D = 0 mod 4
#: (16-byte); views 4, 8 and 12 bytes past a boundary at D = 1 to 7 and at
#: both vector widths; the edges of a tile at K = 10 (512 vectors: 1,024
#: columns at 8 bytes, 2,048 at 16)
AGG_CASES = tuple((K, D, 0) for K in tuple(range(1, 17)) + (17, 20, 33)
                  for D in (4099, 4098, 4100))
AGG_CASES += tuple((K, D, off) for K in (1, 3, 10, 17)
                   for D in (1, 2, 3, 5, 6, 7, 4098, 4100) for off in (4, 8, 12))
AGG_CASES += tuple((10, D, 0) for D in (1022, 1024, 1026, 2044, 2048, 2052))


def aggregate_plan_expected(K, D, offset):
    """(K specialisation, bytes a load, loads a thread, head, vectors,
    tail, tiles) that ``ops.masked_aggregate_plan`` must report for updates
    (K, D) ``offset`` bytes past a 16-byte boundary (csrc/aggregate.cu:
    16-byte loads where every row start shares the offset, D % 4 == 0 or
    one row, 8-byte ones where D is even, else 4-byte; at least 16 loads a
    thread; tiles of 256 threads' vectors)."""
    V = 4 if K == 1 or D % 4 == 0 else 2 if D % 2 == 0 else 1
    head = min((4 * V - offset % (4 * V)) % (4 * V) // 4, D)
    vectors = (D - head) // V
    spec = K if K <= 16 else 0
    vecs = 1 if spec in (0, 16) else -(-16 // K)
    loads = 16 if spec == 0 else K * vecs
    return (spec, 4 * V, loads, head, vectors, D - head - V * vectors,
            -(-vectors // (256 * vecs)))


def aggregate_paths_phase(torch, ops, tref):
    """``masked_aggregate`` against its plain version, ``torch.equal``, at
    AGG_CASES, f32 and int32 updates, weights with a zero and all zero: its
    launch plan as predicted, one launch counted a call, the output at the
    updates' offset; each case again with a denominator on the card,
    counted once as ``masked_aggregate_den``.  Prints the launches by path
    (K specialisation, bytes a load).  Returns the max abs errors without
    and with the denominator."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    err, err_den, cases, paths = 0.0, 0.0, 0, {}
    for K, D, off in AGG_CASES:
        x = at_offset(torch, (torch.rand(K * D, generator=gen, device="cuda") - 0.5)
                      * 0.02, off).view(K, D)
        ints = at_offset(torch, torch.randint(-128, 128, (K * D,), generator=gen,
                                              device="cuda", dtype=torch.int32),
                         off).view(K, D)
        w = torch.rand(K, generator=gen, device="cuda") * 0.2
        if K > 1:
            w[-1] = 0.0
        for upd in (x, ints):
            plan = ops.masked_aggregate_plan(upd)
            what = f"K={K} D={D} +{off} {upd.dtype} plan {plan}"
            check(tuple(plan)[:7] == aggregate_plan_expected(K, D, off)
                  and 1 <= plan.blocks <= max(plan.tiles, 1), f"aggregate plan: {what}")
            for wts in (w, torch.zeros_like(w)):
                before = ops.LAUNCHES["masked_aggregate"]
                got = ops.masked_aggregate(upd, wts)
                check(ops.LAUNCHES["masked_aggregate"] == before + 1,
                      f"aggregate not counted once: {what}")
                torch.cuda.synchronize()
                want = tref.masked_aggregate_ref(upd, wts)
                err = max(err, _max_diff(got, want))
                check(torch.equal(got, want), f"aggregate differs: {what}")
                check(got.data_ptr() % 16 == off, f"aggregate output offset: {what}")
                den = wts.sum() * 0.75 + 0.01
                before = ops.LAUNCHES["masked_aggregate_den"]
                got = ops.masked_aggregate(upd, wts, den=den)
                check(ops.LAUNCHES["masked_aggregate_den"] == before + 1,
                      f"aggregate with den not counted once: {what}")
                torch.cuda.synchronize()
                want = tref.masked_aggregate_ref(upd, wts, den=den)
                err_den = max(err_den, _max_diff(got, want))
                check(torch.equal(got, want), f"aggregate with den differs: {what}")
                check(got.data_ptr() % 16 == off,
                      f"aggregate with den output offset: {what}")
                key = (plan.k_spec, plan.load_bytes)
                paths[key] = paths.get(key, 0) + 2
                cases += 2
    specs = sorted({k for k, _ in paths})
    check(specs == list(range(17)), f"K specialisations launched: {specs}")
    check({b for _, b in paths} == {4, 8, 16}, f"load widths launched: {paths}")
    print(f"aggregate == plain (torch.equal) in {cases} cases: K 1-16 and "
          f"generic (17, 20, 33), D = 0-3 mod 4, views at byte offsets 4/8/12, "
          f"tile edges, f32 and int32, weights with a zero and all zero, "
          f"each without and with a denominator; "
          f"launches by (K specialisation, bytes a load): "
          + ", ".join(f"{k}/{b}B {n}" for (k, b), n in sorted(paths.items())))
    return err, err_den


def quantizer_paths_phase(torch, ops, tref):
    """The quantizer's two kernels against their plain versions,
    ``torch.equal``, on each path their C side picks: flat sizes
    QUANTIZER_SIZES from aligned pointers (every head and tail length),
    and contiguous views QUANTIZER_OFFSETS bytes past a 16-byte boundary,
    x and u at equal offsets (the 16-byte path behind a scalar head) and at
    different ones (the scalar kernel), codes views for dequantize; bits
    1, 8 and 24 at clip 1 and 0.3 with the edge values, both roundings
    (nearest with no noise).  Prints the path of each case and checks it
    is the one the offsets call for.  Returns the max abs error of each."""
    err = {"stochastic_quantize_codes": 0.0, "dequantize_codes": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(4)
    # a checkout from before the 16-byte path has no plan to report
    plan_of = getattr(ops, "quantizer_plan", None)
    cases = 0

    def held(kind, got, want, plan, vector, what):
        nonlocal cases
        torch.cuda.synchronize()
        err[kind] = max(err[kind], _max_diff(got, want))
        check(torch.equal(got, want), f"{kind} differs: {what}")
        if plan is not None:
            check(plan.vector == vector, f"{kind} took the "
                  f"{'16-byte' if plan.vector else 'scalar'} path: {what}")
        cases += 1

    def path(plan):
        return "not reported" if plan is None else (
            f"{'16-byte' if plan.vector else 'scalar'} "
            f"{plan.head}/{plan.vectors}/{plan.tail}")

    layouts = [(n, 0, 0) for n in QUANTIZER_SIZES]
    layouts += [(n, ox, ou) for n in (5, 4099) for ox, ou in QUANTIZER_OFFSETS]
    for n, ox, ou in layouts:
        x = at_offset(torch, (torch.rand(n, generator=gen, device="cuda") - 0.5) * 3, ox)
        u = at_offset(torch, torch.rand(n, generator=gen, device="cuda"), ou)
        plans = {}
        for bits in (1, 8, 24):
            for clip in (1.0, 0.3):
                edge = _edge_values(torch, bits, clip)[:n]
                x[:edge.numel()] = edge
                for stochastic in (True, False):
                    noise = u if stochastic else None
                    got = ops.stochastic_quantize_codes(
                        x, noise, bits, clip=clip, stochastic=stochastic)
                    plan = plan_of(x, noise, got) if plan_of else None
                    held("stochastic_quantize_codes", got,
                         tref.stochastic_quantize_ref(x, noise, bits, clip=clip,
                                                      stochastic=stochastic),
                         plan, not stochastic or ox == ou,
                         f"n={n} x+{ox} u+{ou} bits={bits} clip={clip} "
                         f"stochastic={stochastic}")
                    plans["stochastic" if stochastic else "nearest"] = plan
        for bits in (1, 8, 24):
            g = 2 ** (bits - 1)
            codes = at_offset(torch, torch.randint(-g, g, (n,), generator=gen,
                                                   device="cuda", dtype=torch.int32), ox)
            for clip in (1.0, 0.3):
                got = ops.dequantize_codes(codes, bits, clip=clip)
                plans["dequantize"] = plan_of(codes, None, got) if plan_of else None
                held("dequantize_codes", got,
                     tref.dequantize_ref(codes, bits, clip=clip),
                     plans["dequantize"], True,
                     f"n={n} codes+{ox} bits={bits} clip={clip}")
        print(f"  quantizer path (head/vectors/tail) n={n} x and codes +{ox} "
              f"u +{ou}: " + ", ".join(f"{k} {path(p)}" for k, p in plans.items()))
    print(f"quantizer kernels == plain (torch.equal) in {cases} cases: sizes "
          f"{list(QUANTIZER_SIZES)}, views at byte offsets (x, u) "
          f"{list(QUANTIZER_OFFSETS)}, bits 1/8/24, clip 1/0.3, both roundings")
    return err


def at_offset(torch, values, offset):
    """A contiguous copy of ``values`` ``offset`` bytes past a 16-byte
    boundary: a view into a buffer 4 elements longer."""
    buf = torch.empty(values.numel() + 4, dtype=values.dtype, device="cuda")
    k = (offset - buf.data_ptr() % 16) % 16 // 4
    out = buf[k:k + values.numel()].copy_(values.reshape(-1))
    check(out.data_ptr() % 16 == offset, f"no view at offset {offset}")
    return out.view(values.shape)


def wire_quantizer_paths_phase(torch, ops, tref):
    """quantize_pack and quantize_pack_chunk (k = 1 and 3) against their
    plain versions, ``torch.equal``, at WIRE_QUANT_CASES (every
    codes-per-word specialisation), clips 1, 0.3 and 2.5, both roundings,
    on 1 and 10 rows of W = 4,099 words (odd, n not a multiple of cpw) and
    4,100 (even, n a multiple), x and u views at byte offsets 0, 4, 8 and
    12 past a 16-byte boundary (equal and different), led by the edge
    values.  Checks each launch's ``ops.pack_plan`` (specialisation, words
    a thread, 4-byte loads, tiles, one wave) and prints it at the main
    shapes.  Returns the max abs error of each kernel."""
    err = {"quantize_pack": 0.0, "quantize_pack_chunk": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(6)
    offsets = ((0, 0), (4, 4), (8, 8), (12, 12), (4, 12), (8, 0))
    cases, cpws = 0, set()
    # a checkout from before the redesign has no plan to report
    plan_of = getattr(ops, "pack_plan", None)

    def held(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        err[name] = max(err[name], _max_diff(got, want))
        check(torch.equal(got, want), f"{name} differs: {what}")
        cases += 1

    def planned(x, bits, lane, stochastic, k, what):
        if plan_of is None:
            return None
        plan = plan_of(x, bits, lane_bits=lane, stochastic=stochastic,
                       num_chunks=k)
        cpw, segments = 32 // lane, max(k, 1)
        words = WIRE_QUANT_WORDS[cpw]
        C = -(-x.shape[1] // segments)
        W = -(-C // cpw)
        tiles = x.shape[0] * segments * -(-W // (256 * words))
        check(plan.cpw == cpw and plan.words == words and plan.load_bytes == 4
              and plan.tiles == tiles and 1 <= plan.blocks <= tiles,
              f"pack plan {plan} for {what}")
        cpws.add(plan.cpw)
        return plan

    i = 0
    for bits, lane in WIRE_QUANT_CASES:
        cpw = 32 // lane
        for rows, W in ((1, 4099), (10, 4099), (1, 4100), (10, 4100)):
            n = cpw * W - (W % 2 and cpw > 1)
            ox, ou = offsets[i % len(offsets)]
            i += 1
            x = at_offset(torch, (torch.rand((rows, n), generator=gen,
                                             device="cuda") - 0.5) * 3, ox)
            u = at_offset(torch, torch.rand((rows, n), generator=gen,
                                            device="cuda"), ou)
            for clip in (1.0, 0.3, 2.5):
                edge = _edge_values(torch, bits, clip)[:n]
                x[0, :edge.numel()] = edge
                x[-1, -edge.numel():] = edge
                for stochastic in (True, False):
                    noise = u if stochastic else None
                    what = (f"bits={bits} lane={lane} rows={rows} n={n} "
                            f"x+{ox} u+{ou} clip={clip} stochastic={stochastic}")
                    kw = dict(clip=clip, lane_bits=lane, stochastic=stochastic)
                    planned(x, bits, lane, stochastic, 0, what)
                    held("quantize_pack", ops.quantize_pack(x, noise, bits, **kw),
                         tref.quantize_pack_ref(x, noise, bits, **kw), what)
                    for k in (1, 3):
                        planned(x, bits, lane, stochastic, k, what + f" k={k}")
                        got = ops.quantize_pack_chunk(x, noise, bits,
                                                      num_chunks=k, **kw)
                        want = tref.quantize_pack_chunk_ref(x, noise, bits,
                                                            num_chunks=k, **kw)
                        held("quantize_pack_chunk", got[0], want[0], what + f" k={k}")
                        held("quantize_pack_chunk", got[1], want[1], what + f" k={k}")
    check(plan_of is None or cpws == set(WIRE_QUANT_WORDS),
          f"cases miss a specialisation: {cpws}")
    C, D = SHAPES["main"]
    x = torch.empty((C, D), device="cuda")
    for label, lane, k in (("quantize_pack", 12, 0), ("quantize_pack_chunk", 8, 1)):
        p = planned(x, 8, lane, True, k, f"{label} main shape")
        print(f"  {label} at the main shape (lane {lane}): " + (
            "plan not reported" if p is None else
            f"cpw {p.cpw}, {p.words} words a thread, {p.load_bytes}-byte "
            f"loads, {p.tiles} tiles over {p.blocks} blocks"))
    print(f"wire quantizers == plain (torch.equal) in {cases} cases: "
          f"codes per word {sorted(cpws, reverse=True)}, bits 1-24, clips "
          f"1/0.3/2.5, both roundings, 1 and 10 rows, W odd and even, views "
          f"at byte offsets {list(offsets)}")
    return err


def _max_diff(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def wire_kernels_phase(torch, ops, tref, quant):
    """The five wire kernels against their plain versions, ``torch.equal``:
    bits {1,2,4,8} x clip {1, 0.3} x both roundings at lanes {bits,
    bits+ceil(log2 C), 32}; the un-bias by sum_of·G and by an explicit
    bias; quantize_pack_chunk at k in {1, 3, 4}; repack at hops 0, 1, C-1
    and along each axis of the (2, 5) grid, its cases between them
    launching all ten codes-per-word specialisations, and nine consecutive
    hops into one acc, the ring's in-place pattern; pack_sums at every rsag
    hop lane of 8 bits at C=10 (lanes 8-12, lane-symmetric bias), at lane
    32 with the bias 2^31 and at the two-axis ring's level change (lane 9,
    sums of 2)."""
    err = {k: 0.0 for k in ("quantize_pack", "unpack_dequantize",
                            "quantize_pack_chunk", "repack", "pack_sums")}
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = 0
    # codes per word of the cases launched, by kernel
    cpws = {k: set() for k in ("unpack_dequantize", "repack", "pack_sums")}
    # a checkout from before the redesign has no plan to report
    plans = {k: getattr(ops, f"{k}_plan", None)
             for k in ("pack_sums", "unpack_dequantize")}

    def planned(kind, t, lane, rows, W):
        """Checks the launch plan of ``kind`` for ``t`` (rows of W words at
        ``lane``, 8 or fewer bits) and records its specialisation."""
        cpw = 32 // lane
        cpws[kind].add(cpw)
        if plans[kind] is None:
            return None
        p = plans[kind](t, min(lane, 8), lane_bits=lane)
        words = (SUM_WORDS if kind == "pack_sums" else UNPACK_WORDS)[cpw]
        tiles = rows * -(-W // (256 * words))
        check(p.cpw == cpw and p.words == words and p.load_bytes == 4
              and p.tiles == tiles and 1 <= p.blocks <= tiles,
              f"{kind} plan {p} at lane {lane}, {rows} rows of {W} words")
        return p

    def same(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        err[name] = max(err[name], _max_diff(got, want))
        check(torch.equal(got, want), f"{name} differs: {what}")
        cases += 1

    for label, (C, D) in SHAPES.items():
        x = (torch.rand((C, D), generator=gen, device="cuda") - 0.5) * 3
        u = torch.rand((C, D), generator=gen, device="cuda")
        for bits in (1, 2, 4, 8):
            lanes = sorted({bits, quant.packed_lane_bits(bits, C), 32})
            g = 2 ** (bits - 1)
            for clip in (1.0, 0.3):
                xc = x * clip
                for stochastic, lane in ((s, l) for s in (True, False)
                                         for l in lanes):
                    what = f"{label} bits={bits} clip={clip} lane={lane} " \
                           f"stochastic={stochastic}"
                    kw = dict(clip=clip, lane_bits=lane, stochastic=stochastic)
                    same("quantize_pack", ops.quantize_pack(xc, u, bits, **kw),
                         tref.quantize_pack_ref(xc, u, bits, **kw), what)
                    for k in (1, 3, 4):
                        got = ops.quantize_pack_chunk(xc, u, bits, num_chunks=k,
                                                      **kw)
                        want = tref.quantize_pack_chunk_ref(xc, u, bits,
                                                            num_chunks=k, **kw)
                        same("quantize_pack_chunk", got[0], want[0], what + f" k={k}")
                        same("quantize_pack_chunk", got[1], want[1], what + f" k={k}")
                for lane in lanes:
                    m = 2 ** (lane - bits) if lane < 32 else C   # sum_of that fits
                    m = min(m, C)
                    codes = torch.randint(-g * m, (g - 1) * m + 1, (C, D),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32)
                    for sum_of, bias in ((m, None), (1, quant.lane_bias(lane))):
                        if bias is not None:
                            codes = codes.clamp(-g, g - 1)
                        words = quant.pack_codes(codes, bits, lane_bits=lane,
                                                 sum_of=sum_of, bias=bias)
                        kw = dict(lane_bits=lane, sum_of=sum_of, bias=bias)
                        what = f"{label} bits={bits} lane={lane} sum_of={sum_of} bias={bias}"
                        planned("unpack_dequantize", words, lane, C,
                                words.shape[1])
                        planned("pack_sums", codes, lane, C, words.shape[1])
                        cpws["repack"].add(32 // lane)
                        same("unpack_dequantize",
                             ops.unpack_dequantize(words, bits, D, clip=clip, **kw),
                             tref.unpack_dequantize_ref(words, bits, D, clip=clip, **kw),
                             what + f" clip={clip}")
                        for hop in (0, 1, C - 1):
                            acc = codes.clone()
                            got = ops.repack(words, acc, bits, D, hop=hop, **kw)
                            check(got.data_ptr() == acc.data_ptr(),
                                  "repack must update acc in place")
                            same("repack", got,
                                 tref.repack_ref(words, codes.clone(), bits, D,
                                                 hop=hop, **kw),
                                 what + f" hop={hop}")
                        same("pack_sums",
                             ops.pack_sums(codes, bits, lane_bits=lane,
                                           sum_of=sum_of, bias=bias),
                             tref.pack_sums_ref(codes, bits, lane_bits=lane,
                                                sum_of=sum_of, bias=bias),
                             what)
    C, D = SHAPES["main"]
    chunk = -(-D // C)
    g = 128
    for lane in sorted({quant.packed_lane_bits(8, h) for h in range(1, C + 1)}):
        m = min(2 ** (lane - 8), C)             # the codes a lane can sum
        sums = torch.randint(-g * m, (g - 1) * m + 1, (C, chunk),
                             generator=gen, device="cuda", dtype=torch.int32)
        kw = dict(lane_bits=lane, bias=quant.lane_bias(lane))
        planned("pack_sums", sums, lane, C, quant.packed_words(chunk, 8, lane_bits=lane))
        same("pack_sums", ops.pack_sums(sums, 8, **kw),
             tref.pack_sums_ref(sums, 8, **kw), f"rsag hop shape lane={lane}")
    sums = torch.randint(-2 ** 30, 2 ** 30, (C, chunk), generator=gen,
                         device="cuda", dtype=torch.int32)
    same("pack_sums", ops.pack_sums(sums, 8, lane_bits=32, bias=2 ** 31),
         tref.pack_sums_ref(sums, 8, lane_bits=32, bias=2 ** 31),
         "lane 32, bias 2^31")
    sums = torch.randint(-2 * g, 2 * (g - 1) + 1, (C, D), generator=gen,
                         device="cuda", dtype=torch.int32)
    same("pack_sums", ops.pack_sums(sums, 8, lane_bits=9, sum_of=2),
         tref.pack_sums_ref(sums, 8, lane_bits=9, sum_of=2),
         "two-axis ring level change")
    words = quant.pack_codes(sums, 8, lane_bits=9, sum_of=2)
    cpws["repack"].add(quant.codes_per_word(8, lane_bits=9))
    for axis, inner, hops in ((2, 5, (1,)), (5, 1, (1, 2, 3, 4))):
        for hop in hops:
            kw = dict(hop=hop, lane_bits=9, sum_of=2, axis_size=axis,
                      inner=inner)
            same("repack", ops.repack(words, sums.clone(), 8, D, **kw),
                 tref.repack_ref(words, sums.clone(), 8, D, **kw),
                 f"(2, 5) grid axis={axis} inner={inner} hop={hop}")
    codes = torch.randint(-g, g, (C, D), generator=gen, device="cuda",
                          dtype=torch.int32)
    words = quant.pack_codes(codes, 8)
    acc, want = codes.clone(), codes.clone()
    for hop in range(1, C):                 # one ring's hops, in place
        ops.repack(words, acc, 8, D, hop=hop)
        tref.repack_ref(words, want, 8, D, hop=hop)
    same("repack", acc, want, f"{C - 1} consecutive hops into one acc")
    check(torch.equal(acc, codes.sum(0, dtype=torch.int32).expand(C, D)),
          "the ring's hops must leave every row holding the sum")
    for kind, seen in cpws.items():
        print(f"{kind} launched codes-per-word specialisations "
              f"{sorted(seen, reverse=True)}")
        check(seen == set(SUM_WORDS),
              f"{kind} cases miss a codes-per-word count: {sorted(seen)}")
    W9, Wp, Wh = (quant.packed_words(D, 8, lane_bits=9),
                  quant.packed_words(D, 8, lane_bits=12),
                  quant.packed_words(chunk, 8, lane_bits=12))
    for kind, what, t, lane, rows, W in (
            ("pack_sums", "the level change", sums, 9, C, W9),
            ("pack_sums", "an rsag hop", sums[:, :chunk], 12, C, Wh),
            ("unpack_dequantize", "the packed psum",
             torch.empty(Wp, dtype=torch.int32, device="cuda"), 12, 1, Wp),
            ("unpack_dequantize", "rsag's last store",
             torch.empty((C, Wh), dtype=torch.int32, device="cuda"), 12, C, Wh)):
        p = planned(kind, t, lane, rows, W)
        print(f"  {kind} at {what} (lane {lane}, {rows} rows of {W:,} words): "
              + ("plan not reported" if p is None else
                 f"cpw {p.cpw}, {p.words} words a thread, {p.load_bytes}-byte "
                 f"loads, {p.tiles} tiles over {p.blocks} blocks"))
    print(f"wire kernels == plain (torch.equal) in {cases} cases at the main "
          f"(C=10, D=421,642), rsag hop (C=10, {chunk:,}) and ragged (C=3, "
          f"D=5,003) shapes")
    return err


def qmatmul_phase(torch, ops, tref):
    """qmatmul against its plain version, ``torch.equal``, at
    QMATMUL_SHAPES (the last all 127, the exact-accumulation case) and at
    QMATMUL_EDGES, which between them take every staging of x and w; then
    the entry point driven once per shape with the launch counts reset
    just before, which is the count the kernels line reports."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    inputs = []
    err = 0.0

    def operand(rows, cols, offset, fill):
        buf = torch.randint(-128, 128, (rows * cols + offset,), generator=gen,
                            device="cuda", dtype=torch.int8)
        if fill is not None:
            buf.fill_(fill)
        return buf[offset:].view(rows, cols)

    def held(x, w, what):
        nonlocal err
        got = ops.qmatmul(x, w, 0.01, 0.02)
        want = tref.qmatmul_ref(x, w, 0.01, 0.02)
        torch.cuda.synchronize()
        err = max(err, _max_diff(got, want))
        check(torch.equal(got, want), f"qmatmul differs at {what}")

    for M, K, N in QMATMUL_SHAPES:
        x, w = operand(M, K, 0, 127 if K == 4096 else None), \
            operand(K, N, 0, 127 if K == 4096 else None)
        inputs.append((x, w))
        held(x, w, (M, K, N))
        if K == 4096:
            exact = ops.qmatmul(x, w, 1.0, 1.0)
            check(float(exact[0, 0]) == 127 * 127 * K,
                  f"qmatmul accumulation inexact: {float(exact[0, 0])}")
    staged = set()
    for M, K, N, offset, fill in QMATMUL_EDGES:
        x, w = operand(M, K, offset, fill), operand(K, N, offset, fill)
        geo = ops.qmatmul_plan(x, w)
        staged |= {("x", geo.x_vec), ("w", geo.w_vec)}
        held(x, w, (M, K, N, f"offset {offset}", f"fill {fill}"))
        print(f"  qmatmul edge {(M, K, N)} offset {offset} fill {fill}: "
              f"split {geo.split}, staging x {geo.x_vec} B, w {geo.w_vec} B")
        if fill is not None:
            exact = ops.qmatmul(x, w, 1.0, 1.0)
            check(float(exact[0, 0]) == fill * fill * K,
                  f"qmatmul accumulation inexact: {float(exact[0, 0])}")
    check(staged == {(o, v) for o in "xw" for v in (16, 1)},
          f"qmatmul edges staged only {sorted(staged)}")
    ops.reset_launch_counts()
    outs = [ops.qmatmul(x, w, 0.05, 0.1) for x, w in inputs]
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["qmatmul"] == len(QMATMUL_SHAPES)
          and sum(launches.values()) == len(QMATMUL_SHAPES),
          f"qmatmul entry point launches {launches}")
    check(all(bool(torch.isfinite(o).all()) for o in outs), "non-finite qmatmul")
    print(f"qmatmul == plain (torch.equal) at {list(QMATMUL_SHAPES)} and at "
          f"{len(QMATMUL_EDGES)} edge inputs (every staging of x and w); "
          f"K=4096 accumulation exact at 127 and -128; entry point launches "
          f"{launches['qmatmul']}, one a call")
    return err, launches["qmatmul"]


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
    want = {k: 0 for k in ops.LAUNCHES}
    want.update({"stochastic_quantize_codes": (I + 1) * R,
                 "dequantize_codes": (I + 1) * R, "masked_aggregate": R,
                 "fma_step": I * R})
    print(f"launches on the main path ({R} rounds): {launches}")
    check(launches == want, f"launch counts {launches} != predicted {want}")
    return launches, sim, params


class WeightStore:
    """The client store a simulator's constructor reads for a round on
    prepared inputs: the client weights and the store's device."""

    def __init__(self, torch, device):
        self.device = torch.device(device)

    def client_weights(self):
        return [0.1] * 10


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
    out = {}
    for dev in ("cpu", "cuda"):
        sim = FLSimulator(model, cfg, WeightStore(torch, dev), device=dev)
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


def cohort_config(get_config, mode_hops=True, *, I=3, micro=32, C=10, q=0.01):
    cfg = paper_config(get_config, K=C, I=I, batch=C * I * micro)
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, pipeline_hops=mode_hops),
        channel=dataclasses.replace(cfg.channel, error_prob=q))


def predicted_cohort_launches(collective, hops, axis_sizes, ste_steps, R,
                              auto="packed"):
    """Launches of R cohort rounds, counted from the reference's schedules
    (``src/repro/core/aggregation.py`` ``_reduce_ring``, ``_rsag_level``,
    ``_reduce_rsag``).  The STE takes one quantize and one dequantize per
    local step of a model that trains quantized (``ste_steps``: I for the
    QNN, 0 for the LM, ``model.quantizes_training``) in every mode, and the
    QNN's float32 step one ``fma_step`` over its (C, D) parameters (the
    bfloat16 LM's step launches none: also ``ste_steps``); the
    uplink as the wire format runs it, "auto" resolving to ``auto``
    (packed for the QNN at (10,) and at (2, 5), 8 bits; the ring at (2,)).
    Per non-trivial axis of K entries:

    * ring: K - 1 repacks, and a pack_sums of the partial sums before every
      axis but the first; front-end quantize_pack_chunk (pipelined) or
      quantize_pack and a repack from zero; one dequantize of the sum.
    * rsag: K - 1 scatter hops of one pack_sums and one repack each, the
      first axis's hop-1 pack_sums done by the quantize_pack_chunk front
      under ``pipeline_hops`` (otherwise the quantize kernel runs first);
      the gather's pack_sums; a repack into zeros before the last axis and
      one unpack_dequantize after it.

    So (10,): ring 1 chunk + 9 repack + 1 dequantize, rsag 1 chunk + 9
    repack + 9 pack_sums + 1 unpack; (2, 5): ring 1 chunk + 5 repack + 1
    pack_sums + 1 dequantize, rsag 1 chunk + 6 repack + 6 pack_sums + 1
    unpack (pipelined)."""
    ks = [k for k in axis_sizes if k > 1]
    if collective == "auto":
        collective = auto
    if collective in ("paper", "int"):
        up = {"stochastic_quantize_codes": 1, "dequantize_codes": 1}
    elif collective == "packed":
        up = {"quantize_pack": 1, "unpack_dequantize": 1}
    elif collective == "ring":
        up = ({"quantize_pack_chunk": 1} if hops else
              {"quantize_pack": 1, "repack": 1})
        up["repack"] = up.get("repack", 0) + sum(k - 1 for k in ks)
        up.update({"pack_sums": len(ks) - 1, "dequantize_codes": 1})
    else:   # rsag
        up = ({"quantize_pack_chunk": 1} if hops else
              {"stochastic_quantize_codes": 1})
        up.update({"repack": sum(k - 1 for k in ks) + len(ks) - 1,
                   "pack_sums": sum(ks) - int(hops),
                   "unpack_dequantize": 1})
    per_round = {"stochastic_quantize_codes": ste_steps,
                 "dequantize_codes": ste_steps, "fma_step": ste_steps}
    for k, v in up.items():
        per_round[k] = per_round.get(k, 0) + v
    return {k: v * R for k, v in per_round.items() if v}


def cohort_round_phase(torch, ops, get_config, build_model, digit_dataset,
                       make_fl_round, smi):
    """The cohort round at full width: the QNN over C=10 cohorts, I=3, 32
    images per microbatch, on each layout of COHORT_MODES in each of its
    wire formats, COHORT_ROUNDS rounds each from the same parameters,
    batches and generator seed.  The launch counts are set to 0 just
    before each format's rounds and read just after."""
    C, I, micro, R = 10, 3, 32, COHORT_ROUNDS
    cfg = cohort_config(get_config, I=I, micro=micro, C=C)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = digit_dataset(gen, R * C * I * micro)
    batches = [{k: v[r * C * I * micro:(r + 1) * C * I * micro]
                for k, v in data.items()} for r in range(R)]
    params0 = torch.cat([v.reshape(-1) for _, v in sorted(model.init(1).items())])
    # warm-up (cuDNN's first calls), outside the counted runs
    make_fl_round(model, cfg, (C,), collective="paper")(
        params0, batches[0], torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()
    total = {k: 0 for k in ops.LAUNCHES}
    results = {}
    for sizes, modes in COHORT_MODES.items():
        for label, collective, hops in modes:
            fn = make_fl_round(model, cohort_config(get_config, hops, I=I,
                                                    micro=micro, C=C),
                               sizes, collective=collective)
            g = torch.Generator(device="cuda").manual_seed(11)
            params, hist, ms = params0, [], []
            ops.reset_launch_counts()
            for r in range(R):
                t0 = time.perf_counter()
                params, m = fn(params, batches[r], g)
                loss = float(m["loss"])              # waits for the round
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                hist.append((params, loss, float(m["survivors"]),
                             m["wire_bits_per_param"]))
            launches = dict(ops.LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            want = {k: 0 for k in ops.LAUNCHES}
            want.update(predicted_cohort_launches(
                collective, hops, sizes, I if model.quantizes_training else 0,
                R))
            check(launches == want,
                  f"{sizes} {label}: launches {launches} != predicted {want}")
            losses = [h[1] for h in hist]
            check(all(map(math.isfinite, losses)),
                  f"{sizes} {label}: non-finite loss {losses}")
            check(all(bool(torch.isfinite(h[0]).all()) for h in hist),
                  f"{sizes} {label}: non-finite parameters")
            check(abs(hist[0][3] - COHORT_WIRE_BITS[sizes][collective]) < 1e-9,
                  f"{sizes} {label}: wire bits {hist[0][3]} != "
                  f"{COHORT_WIRE_BITS[sizes][collective]}")
            results[sizes, label] = hist
            print(json.dumps({"cohort_round": label, "axis_sizes": list(sizes),
                              "collective": collective, "pipeline_hops": hops,
                              "C": C, "I": I, "global_batch": C * I * micro,
                              "losses": losses,
                              "survivors": [h[2] for h in hist],
                              "wire_bits_per_param": hist[0][3],
                              "round_ms": ms,
                              "round_ms_median": sorted(ms)[R // 2],
                              "launches": {k: v for k, v in launches.items() if v},
                              "card": smi}))
        for r in range(R):
            for label, _, _ in modes:
                if label != "paper":
                    check(torch.equal(results[sizes, label][r][0],
                                      results[sizes, "int"][r][0]),
                          f"{sizes} round {r}: {label} params differ from int")
    packed = [h[1] for h in results[(C,), "packed"]]
    check(packed[-1] < packed[0], f"packed loss did not fall: {packed}")
    for r in range(R):
        check(torch.equal(results[(2, 5), "int"][r][0],
                          results[(C,), "int"][r][0]),
              f"round {r}: int at (2, 5) differs from int at (10,)")
    print(f"cohort round: params torch.equal across int, packed, ring and "
          f"rsag (both front-ends) and auto after each of {R} rounds at "
          f"(10,) and at (2, 5), and between the layouts; launches and wire "
          f"bits as predicted")
    for sizes, mode in (((C,), "packed"), ((C,), "rsag"), ((2, 5), "rsag")):
        round_fn = make_fl_round(model, cfg, sizes, collective=mode)
        g = torch.Generator(device="cuda").manual_seed(3)
        profile_phase(torch, f"make_fl_round {mode} {sizes}",
                      lambda: round_fn(params0, batches[0], g))
    return total


def cohort_reference_phase(torch, get_config, build_model, make_fl_round,
                           local_sgd, RoundNoise, quant, sizes, collective):
    """One small cohort round on the card against the same round on the CPU
    (C=4 cohorts laid out as ``sizes``, I=2, 8 images per microbatch), the
    slice-1 bar: uplink codes >= 99.9 % equal and none off by more than 1,
    params within one step."""
    C, I, micro = math.prod(sizes), 2, 8
    cfg = cohort_config(get_config, I=I, micro=micro, C=C, q=0.3)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(7)
    params = torch.cat([v.reshape(-1) for _, v in sorted(
        model.init(3, device="cpu").items())])
    D = params.numel()
    B = C * I * micro
    batch = {"images": torch.rand((B, 28, 28, 1), generator=gen),
             "labels": torch.randint(0, 10, (B,), generator=gen)}
    noise = RoundNoise(torch.rand((C, I, D), generator=gen),
                       torch.rand((C, D), generator=gen),
                       torch.tensor([1.0, 0.0, 1.0, 1.0]))
    out = {}
    for dev in ("cpu", "cuda"):
        p = params.to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        nz = RoundNoise(*(t.to(dev) for t in noise))
        fn = make_fl_round(model, cfg, sizes, collective=collective, device=dev)
        new, m = fn(p, b, noise=nz)
        cb = {k: v.reshape(C, I, micro, *v.shape[1:]) for k, v in b.items()}
        local, _, _ = local_sgd(model, cfg, p, cb, u_train=nz.u_train)
        x = (local - p) * nz.lam[:, None]       # weighted by alpha·lam·C = lam
        codes = quant.quantize_codes(x.contiguous(), nz.u_up.contiguous(), 8)
        out[dev] = (codes.cpu(), new.cpu(), float(m["loss"]))
    diff = (out["cuda"][0] - out["cpu"][0]).abs()
    agree = float((diff == 0).float().mean())
    perr = (out["cuda"][1] - out["cpu"][1]).abs()
    print(f"card vs CPU, one cohort round {sizes} I={I} microbatch {micro} "
          f"({collective}): uplink codes agree on {agree:.6f}, max code diff "
          f"{float(diff.max()):.0f}, max param diff {float(perr.max()):.3g}, "
          f"loss {out['cuda'][2]:.6f} vs {out['cpu'][2]:.6f}")
    check(float(diff.max()) <= 1 and agree >= 0.999, "cohort uplink codes disagree")
    check(float(perr.max()) <= 1 / 128 and float((perr <= 1e-5).float().mean()) >= 0.999,
          "cohort round parameters disagree with the CPU path")


def fleet_config(cfg, size, selection, policy, reweight=False, **channel):
    """``cfg`` with a fleet of ``size`` devices under ``selection`` and the
    ``policy`` power policy (and channel overrides)."""
    return dataclasses.replace(
        cfg,
        fleet=dataclasses.replace(cfg.fleet, size=size, selection=selection,
                                  error_reweight=reweight),
        power=dataclasses.replace(cfg.power, policy=policy),
        channel=dataclasses.replace(cfg.channel, **channel))


def check_battery(torch, before, after, charged, harvested, what):
    """The fleet's energy moved by exactly the realized charge less the
    harvest: per-device differences summed in float64 (a float32 total of
    5·10^7 J has a 4 J ulp), as tests/test_population.py:426 does."""
    moved = float((before.double() - after.double()).sum())
    want = charged - harvested
    check(abs(moved - want) <= 1e-3 * abs(want) + 0.05,
          f"{what}: battery moved {moved} J, charged less harvested {want} J")
    return moved


def fleet_simulator_phase(torch, ops, sim0, get_config, FLSimulator, convert,
                          smi):
    """``FLSimulator.run_rounds`` over a FLEET_SIZE-device fleet on the
    main path's QNN, store and settings, ROUNDS rounds of each run of
    FLEET_SIM_RUNS; the launch counts set to 0 just before each run and
    read just after.  Checks: loss finite and falling, the selected ids
    valid, the battery conserved, the launches (eq. 6, or with
    error_reweight the IPW aggregate's masked_aggregate_den); then two
    more rounds queued under ``torch.cuda.set_sync_debug_mode("error")``
    (no synchronizing call in the fleet loop), and the device time of a
    traced round.  Returns the runs' launches summed."""
    model, store = sim0.model, sim0.store
    base = paper_config(get_config)
    I, R = base.fl.local_iters, ROUNDS
    total = {k: 0 for k in ops.LAUNCHES}
    for selection, policy, reweight in FLEET_SIM_RUNS:
        label = f"{selection}/{policy}" + ("/ipw" if reweight else "/eq6")
        cfg = fleet_config(base, FLEET_SIZE, selection, policy, reweight)
        t0 = time.perf_counter()
        sim = FLSimulator(model, cfg, store)
        params0 = convert.flatten_params(model.init(1))
        before = sim.fleet_state.battery_j.clone()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(2)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, hist = sim.run_rounds(params0, R, gen)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        losses = [h["loss"] for h in hist]
        check(all(map(math.isfinite, losses)), f"fleet {label}: loss {losses}")
        check(losses[-1] < losses[0], f"fleet {label}: loss did not fall {losses}")
        check(bool(torch.isfinite(params).all()), f"fleet {label}: parameters")
        for h in hist:
            check(len(h["selected"]) == int(h["selected_valid"])
                  and all(0 <= d < FLEET_SIZE for d in h["selected"])
                  and len(set(h["selected"])) == len(h["selected"]),
                  f"fleet {label}: selected {h['selected']}")
        moved = check_battery(torch, before, sim.fleet_state.battery_j,
                              sum(h["cohort_energy_j"] for h in hist),
                              sum(h["harvested_j"] for h in hist),
                              f"fleet {label}")
        want = {k: 0 for k in ops.LAUNCHES}
        want.update({"stochastic_quantize_codes": (I + 1) * R,
                     "dequantize_codes": (I + 1) * R, "fma_step": I * R,
                     "masked_aggregate_den" if reweight
                     else "masked_aggregate": R})
        check(launches == want,
              f"fleet {label}: launches {launches} != predicted {want}")
        torch.cuda.set_sync_debug_mode("error")
        try:
            queued, _ = sim._queue_fleet_rounds(params, 2, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(json.dumps({"fleet_simulator": label, "fleet_size": FLEET_SIZE,
                          "K": base.fl.devices_per_round, "I": I,
                          "rounds": R, "setup_s": setup_s,
                          "rounds_host_ms": run_ms,
                          "round_host_ms_mean": run_ms / R,
                          "rounds_host_ms_is": "run_rounds through its "
                                               "history and a synchronize",
                          "losses": losses,
                          "survivors": [h["survivors"] for h in hist],
                          "selected": [h["selected"] for h in hist],
                          "energy_j": [h["energy_j"] for h in hist],
                          "outage_rate": [h["outage_rate"] for h in hist],
                          "battery_moved_j": moved,
                          "launches": {k: v for k, v in launches.items() if v},
                          "sync_free_rounds": 2, "card": smi}))
        profile_phase(torch, f"FLSimulator fleet {label} {FLEET_SIZE:,}",
                      lambda: sim.run_round(params, gen))
    return total


def telemetry_phase(torch, sim0, get_config, FLSimulator, convert, obs,
                    telemetry, smi):
    """``FLSimulator`` over the FLEET_SIZE-device fleet (the first run of
    FLEET_SIM_RUNS), ROUNDS rounds with the tap off and on, from one
    fleet, parameter vector and generator seed.  The untapped rounds are
    queued under ``torch.cuda.set_sync_debug_mode("error")`` (no
    synchronizing call), then the history read; the tapped ones stream to a
    ``RecordingSink`` through ``obs.scan_sink_tap`` (the simulator wraps it
    in a ``DeferredTap``).  Checks: parameters, fleet and history equal;
    one record a round, valid, equal to the history.  Then the round time,
    host time of ``run_rounds`` through a synchronize over ROUNDS rounds,
    with the tap off and on, interleaved off, on, on, off, three times."""
    from repro_torch.obs import tap as obs_tap

    cfg = fleet_config(paper_config(get_config), FLEET_SIZE,
                       *FLEET_SIM_RUNS[0])
    sim = FLSimulator(sim0.model, cfg, sim0.store)
    fleet0 = sim.fleet_state
    params0 = convert.flatten_params(sim0.model.init(1))
    R = ROUNDS

    def gen():
        return torch.Generator(device="cuda").manual_seed(2)

    sim._queue_fleet_rounds(params0, 1, gen())       # warm
    sim.fleet_state = fleet0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p_off, tels = sim._queue_fleet_rounds(params0, R, gen())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h_off = telemetry.expand_history(telemetry.stack_rounds(tels), R)
    f_off, sim.fleet_state = sim.fleet_state, fleet0
    rec = obs.RecordingSink()
    p_on, h_on = sim.run_rounds(params0, R, gen(),
                                tap=obs_tap.scan_sink_tap(rec))
    check(torch.equal(p_on, p_off), "telemetry: the tap changed the parameters")
    check(all(torch.equal(a, b) for a, b in zip(sim.fleet_state, f_off)),
          "telemetry: the tap changed the fleet")
    check(h_on == h_off, "telemetry: the tap changed the history")
    check(len(rec.records) == R, f"telemetry: {len(rec.records)} records")
    for r, h in zip(rec.records, h_on):
        check(obs.validate_record(r) == [] and r["round"] == h["round"],
              f"telemetry: record {r}")
        for key in ("loss", "accuracy", "survivors", "tau_s",
                    "cohort_energy_j", "battery_total_j", "outage_rate",
                    "harvested_j", "power_q50_w"):
            check(r[key] == h[key], f"telemetry: record {key} {r[key]} != "
                                    f"history {h[key]}")
        sel = [d for d, v in zip(r["selected"], r["valid"]) if v > 0]
        check(sel == h["selected"], f"telemetry: selected {sel}")
    ms = {"off": [], "on": []}
    for order in ("off", "on", "on", "off") * 3:
        sim.fleet_state = fleet0
        tap = obs_tap.scan_sink_tap(obs.RecordingSink()) if order == "on" \
            else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_rounds(params0, R, gen(), tap=tap)
        torch.cuda.synchronize()
        ms[order].append((time.perf_counter() - t0) * 1e3 / R)
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    print(json.dumps({"telemetry": "FLSimulator fleet tap on vs off",
                      "fleet_size": FLEET_SIZE, "rounds": R,
                      "records_equal_history": True, "untapped_sync_free": True,
                      "round_ms_off": ms["off"], "round_ms_on": ms["on"],
                      "round_ms_off_median": med["off"],
                      "round_ms_on_median": med["on"],
                      "round_ms_is": "host time of run_rounds over the rounds "
                                     "through a synchronize, per round",
                      "card": smi}))
    return med


def checkpoint_phase(torch, train_main, get_config, apply_overrides,
                     build_model, smi):
    """The trainer's checkpoints and stream on olmo-1b at full width: 1 step
    in rsag with a COHORT_FLEET_SIZE fleet, ``--checkpoint-every 1`` and a
    telemetry stream, then a resumed run to step 2, in a directory under
    ``build/`` removed afterwards.  Checks: the parameters and fleet
    restored from step 1 ``torch.equal`` to those the first run ended
    with; the resumed step equal to a one-step replay from them with a
    fresh generator (the reference's resume); both records valid.  Prints
    the files' bytes and the save and restore seconds."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch.data.synthetic import token_batch
    from repro_torch.device import make_generator
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps as tsteps
    from repro_torch.obs import validate_record
    from repro_torch.population import fleet as tfleet

    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build"))
    ck, tel = d / "ckpt", d / "tel"
    argv = ["--arch", "olmo-1b", "--devices", "8", "--collective", "rsag",
            "--fleet-size", str(COHORT_FLEET_SIZE), "--log-every", "1",
            "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
            "--telemetry-dir", str(tel), *LM_OVERRIDES]
    host = lambda out: (out["params"].cpu(),
                        [t.cpu() for t in out["fleet"]])
    try:
        a = train_main(argv + ["--steps", "1"])
        a_params, a_fleet = host(a)
        save_s = a["save_s"]
        del a
        sizes = {"params": os.path.getsize(ck / "ckpt_1.msgpack"),
                 "fleet": os.path.getsize(ck / "fleet" / "ckpt_1.msgpack")}
        b = train_main(argv + ["--steps", "2"])
        check(b["start_step"] == 1 and b["steps"] == 2,
              f"checkpoint: resumed {b['start_step']} -> {b['steps']}")
        b_params, b_fleet = host(b)
        resumed_restore_s = b["restore_s"]
        del b
        cfg = apply_overrides(get_config("olmo-1b"), LM_OVERRIDES + (
            f"fleet.size={COHORT_FLEET_SIZE}",))
        model = build_model(cfg)
        D = sum(math.prod(v) for v in model.param_shapes.values())
        check(D == LM_D, f"checkpoint: D = {D}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = ckpt.restore_params(str(ck), torch.empty(
            D, dtype=model.dtype, device="cuda"), model.param_shapes, step=1)
        fleet = tfleet.restore_fleet_checkpoint(
            str(ck / "fleet"), tfleet.init_fleet(cfg.fleet.seed, cfg), step=1)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(torch.equal(params.cpu(), a_params),
              "checkpoint: restored parameters differ from the saved")
        check(all(torch.equal(x.cpu(), y) for x, y in zip(fleet, a_fleet)),
              "checkpoint: restored fleet differs from the saved")
        step_fn, kind = tsteps.make_train_step(
            model, cfg, tmesh.mesh_for_devices(8), collective="rsag")
        check(kind == "fleet_fl_round", f"checkpoint: step kind {kind}")
        gen = make_generator(cfg.fl.seed + 1, torch.device("cuda"))
        batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                            cfg.model.vocab_size)
        params, _, fleet = step_fn(params, batch, gen, fleet)
        check(torch.equal(params.cpu(), b_params),
              "checkpoint: the resumed step differs from its replay")
        check(all(torch.equal(x.cpu(), y) for x, y in zip(fleet, b_fleet)),
              "checkpoint: the resumed fleet differs from its replay")
        del params, fleet
        with open(tel / "telemetry.jsonl") as f:
            records = [json.loads(line) for line in f]
        check([r["round"] for r in records] == [0, 1]
              and all(validate_record(r) == [] for r in records),
              f"checkpoint: records {records}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"checkpoint": "olmo-1b rsag, fleet "
                                    f"{COHORT_FLEET_SIZE:,}, 1 step then resume",
                      "bytes": sizes, "save_s": save_s,
                      "restore_s_in_trainer": resumed_restore_s,
                      "restore_s": restore_s,
                      "restored_equal_saved": True,
                      "resumed_equal_replay": True,
                      "records": [r["round"] for r in records],
                      "save_s_is": "host seconds to write the parameters and "
                                   "the fleet after step 1, from the card",
                      "restore_s_is": "host seconds to read both back onto "
                                      "the card, through a synchronize",
                      "card": smi}))
    return {"bytes": sizes, "save_s": save_s, "restore_s": restore_s}


#: the serving cuts of olmo-1b at full width: (b) prefill_32k's and
#: decode_32k's context at batch 2 (from 32 and 128: the float32 chunked
#: attention's time in prefill), (c) long_500k's window of 8,192 at its
#: batch of 1 under a prompt of 2 windows; each then decodes SERVE_STEPS
SERVE_LONG = {"batch": 2, "prompt": 32_704, "max_len": 32_768}
SERVE_RING = {"batch": 1, "prompt": 16_384}
SERVE_STEPS = 64
#: the reduced float32 models held to the CPU: a prompt of 32 into a cache
#: of 40 (olmo-1b's (c) into a window of 16), then 4 decode steps, every
#: float entry within SERVE_TOL of its largest CPU value
SERVE_SMALL_STEPS = 4
SERVE_TOL = 1e-5


def serve_reference_check(torch, build_model, cfg, prompt, max_len, what):
    """Prefill and SERVE_SMALL_STEPS greedy decode steps of ``cfg`` (a
    reduced float32 olmo-1b, qwen2.5-14b, granite-moe-1b-a400m, rwkv6-7b,
    recurrentgemma-2b, deepseek-v3-671b, chameleon-34b or whisper-base,
    whose prefill also takes normal frames) on the card against the same
    on the CPU, from the same parameters and tokens: the logits and the
    cache's float entries (k and v, the MLA latent, whisper's cross k and
    v, the recurrent states) each within SERVE_TOL of its largest CPU
    value; kv_pos and length equal."""
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.model.vocab_size, (2, prompt), generator=gen,
                         dtype=torch.int32)
    toks_steps = torch.randint(0, cfg.model.vocab_size,
                               (SERVE_SMALL_STEPS, 2, 1), generator=gen,
                               dtype=torch.int32)
    frames = (torch.randn((2, cfg.model.encoder_seq_len, cfg.model.d_model),
                          generator=gen),) if cfg.model.is_encoder_decoder else ()
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        logits, cache = model.prefill(p, toks.to(dev),
                                      *(f.to(dev) for f in frames),
                                      max_len=max_len)
        seen = [logits.cpu()]
        for tok in toks_steps:
            logits, cache = model.decode_step(p, cache, tok.to(dev))
            seen.append(logits.cpu())
        out[dev] = seen, {k: v.cpu() for k, v in cache.items()}

    def close(a, b):
        return float((a - b).abs().max()) <= SERVE_TOL * float(b.abs().max())

    err = max(float((a - b).abs().max())
              for a, b in zip(out["cuda"][0], out["cpu"][0]))
    ok = all(close(a, b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    (gc, wc) = out["cuda"][1], out["cpu"][1]
    floats = [k for k in wc if wc[k].is_floating_point()]
    check(set(gc) == set(wc) and floats, f"serving {what}: cache {set(gc)}")
    cache_err = {k: float((gc[k] - wc[k]).abs().max()) for k in floats}
    ok = ok and all(close(gc[k], wc[k]) for k in floats)
    ok = ok and all(torch.equal(gc[k], wc[k]) for k in wc if k not in floats)
    print(f"card vs CPU, {cfg.model.name} ({cfg.model.n_layers} layers) "
          f"float32 serving ({what}): prefill and {SERVE_SMALL_STEPS} decode "
          f"steps, max logits diff {err:.3g}, max cache diff {cache_err}, "
          f"within {SERVE_TOL:g} of each entry's largest value, kv_pos and "
          f"length equal: {ok}")
    check(ok, f"serving {what}: the card disagrees with the CPU")


def serve_cell(torch, model, params, cfg, batch, prompt, max_len, label,
               prefill_shape, decode_shape, smi, profile=False):
    """Prefill ``batch`` x ``prompt`` tokens into a cache for ``max_len``,
    then SERVE_STEPS greedy decode steps: the first outside, the rest
    under ``torch.cuda.set_sync_debug_mode("error")``, so a synchronizing
    call in ``decode_step`` fails the run, each timed by CUDA events.
    Checks: finite logits, ``length`` advanced by the steps, ``kv_pos`` the
    last C positions.  An encoder-decoder prefills from normal frames
    (``launch.inputs.random_frames``) beside the prompt.  Prints the prefill time (and its host time until
    ``prefill`` returns), the median decode step (and its host time until
    ``decode_step`` returns), tokens/s and peak memory, each beside the
    analytic bound of ``utils.flops.analytic_costs`` on ``utils.roofline``'s
    H100 constants for the cut shape; with ``profile``, one more decode
    step's device kernels and host operators (``profile_phase``)."""
    from repro_torch.launch import inputs
    from repro_torch.utils import flops, roofline

    one_card = {"data": 1, "model": 1}

    def bound(shape, kind):
        c = flops.analytic_costs(cfg, shape, one_card, step_kind=kind)
        return roofline.derive_terms(
            flops_per_device=c.total_flops, bytes_per_device=c.total_bytes,
            collective_bytes_per_device=c.total_collective, num_devices=1,
            model_flops_global=roofline.model_flops(cfg, shape))

    check(inputs.prefill_shape(prefill_shape) == (batch, prompt)
          and inputs.decode_shape(decode_shape) == (batch, 1),
          f"serving {label}: shapes {prefill_shape} {decode_shape}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = inputs.random_tokens((batch, prompt), cfg.model.vocab_size, gen)
    frames = ((inputs.random_frames(cfg, batch, gen),)
              if cfg.model.is_encoder_decoder else ())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, toks, *frames, max_len=max_len)
    prefill_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated()
    C = cache["kv_pos"].shape[1] if "kv_pos" in cache else None
    cache_gb = sum(v.nbytes for v in cache.values()) / 1e9
    check(logits.shape == (batch, cfg.model.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"serving {label}: prefill logits {tuple(logits.shape)}")
    tok = logits.argmax(-1)[:, None]
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    logits, cache = model.decode_step(params, cache, tok)   # first step
    tok = logits[:, -1].argmax(-1)[:, None]
    finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(SERVE_STEPS)]
    host_ms = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        events[0].record()
        for i in range(1, SERVE_STEPS):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits[:, -1].argmax(-1)[:, None]
            finite &= torch.isfinite(logits).all()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            events[i].record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    step_ms = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    decode_ms = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    length = prompt + SERVE_STEPS
    check(bool(finite), f"serving {label}: non-finite decode logits")
    check(int(cache["length"]) == length,
          f"serving {label}: length {int(cache['length'])} != {length}")
    if C is not None:
        pos = torch.arange(max(length - C, 0), length, dtype=torch.int32,
                           device="cuda")
        want = torch.full((C,), -1, dtype=torch.int32, device="cuda")
        want[pos % C] = pos
        check(torch.equal(cache["kv_pos"], want.expand(batch, C)),
              f"serving {label}: kv_pos is not the last {C} positions")
    # a recurrent state or a window's ring: the same bytes at any context
    bounded = C is None or C < length
    cache_bytes_per_seq = sum(v.nbytes for k, v in cache.items()
                              if k != "length") / batch
    if bounded:
        longer = model.init_cache(batch, 2 * length, device="meta")
        check(sum(v.nbytes for k, v in longer.items() if k != "length")
              / batch == cache_bytes_per_seq,
              f"serving {label}: the cache grows with the context")
    if profile:
        profile_phase(torch, f"decode_step {label}",
                      lambda: model.decode_step(params, cache, tok), rounds=3,
                      host_ops=12)
    del cache, logits
    bp, bd = bound(prefill_shape, "prefill"), bound(decode_shape, "decode")
    print(json.dumps({
        "serve": label, "arch": cfg.model.name, "D": model.num_params,
        "dtype": cfg.model.dtype, "window": cfg.model.attention_window,
        "batch": batch, "prompt": prompt, "cache_capacity": C,
        "cache_gb": cache_gb, "cache_bytes_per_sequence": cache_bytes_per_seq,
        "cache_bounded_in_context": bounded,
        "cache_entries": sorted(k for k in model.init_cache(
            1, 1, device="meta") if k != "length"),
        "decode_steps": SERVE_STEPS, "length": length,
        "prefill_ms": prefill_ms, "prefill_host_ms": prefill_host_ms,
        "prefill_tok_s": batch * prompt / prefill_ms * 1e3,
        "prefill_bound_ms": bp.bound_s * 1e3, "prefill_bound_by": bp.dominant,
        "prefill_share_of_bound": bp.bound_s * 1e3 / prefill_ms,
        "decode_ms_median": decode_ms, "decode_ms_quartiles": [
            step_ms[len(step_ms) // 4], step_ms[3 * len(step_ms) // 4]],
        "decode_host_ms_median": sorted(host_ms)[len(host_ms) // 2],
        "decode_tok_s": batch / decode_ms * 1e3,
        "decode_bound_ms": bd.bound_s * 1e3, "decode_bound_by": bd.dominant,
        "decode_share_of_bound": bd.bound_s * 1e3 / decode_ms,
        "prefill_peak_gb": prefill_peak / 1e9, "peak_gb": peak / 1e9,
        "prefill_shape": dataclasses.asdict(prefill_shape),
        "decode_shape": dataclasses.asdict(decode_shape),
        "decode_ms_is": "median of the device time between CUDA events "
                        f"around {SERVE_STEPS - 1} steps queued back to back",
        "bound_is": "utils.roofline.derive_terms(utils.flops.analytic_costs"
                    "(cut shape)) on the H100 SXM datasheet peaks",
        "card": smi}))


def serve_phase(torch, get_config, apply_overrides, build_model, smi):
    """Serving olmo-1b at full width (bfloat16, D = 1,176,764,416, tied
    embeddings): (a) ``launch.serve.main`` at the reference CLI's defaults
    (batch 8, prompt 64, 16 new tokens) with ``--telemetry-dir``, one valid
    ``serve_decode`` record a step; (b) prefill_32k's and decode_32k's
    context at SERVE_LONG; (c) long_500k's window (``for_shape``) at
    SERVE_RING, whose decode steps overwrite ring slots; after (b) and (c)
    a reduced float32 olmo-1b on the card against the CPU."""
    from repro_torch.configs import for_shape
    from repro_torch.configs.shapes import SHAPES, InputShape

    serve_cli_phase(torch, "olmo-1b", smi)
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    check(model.num_params == LM_D and cfg.model.dtype == "bfloat16"
          and cfg.model.tie_embeddings, f"serve: {cfg.model}")
    params = model.init(0)
    long = SERVE_LONG
    serve_cell(torch, model, params, cfg, long["batch"], long["prompt"],
               long["max_len"], "(b) 32k context",
               dataclasses.replace(SHAPES["prefill_32k"],
                                   global_batch=long["batch"],
                                   seq_len=long["prompt"]),
               dataclasses.replace(SHAPES["decode_32k"],
                                   global_batch=long["batch"],
                                   seq_len=long["max_len"]), smi, profile=True)
    serve_reference_check(torch, build_model, apply_overrides(
        get_config("olmo-1b"), LM_SMALL), 32, 40, "(b) max_len 40")
    ring = for_shape(cfg, SHAPES["long_500k"])
    check(ring.model.attention_window == 8192, f"serve: {ring.model}")
    serve_cell(torch, build_model(ring), params, ring, SERVE_RING["batch"],
               SERVE_RING["prompt"], 0, "(c) long_500k window ring",
               InputShape("long_500k_prompt", SERVE_RING["prompt"],
                          SERVE_RING["batch"], "prefill"),
               SHAPES["long_500k"], smi, profile=True)
    serve_reference_check(torch, build_model, apply_overrides(
        get_config("olmo-1b"), LM_SMALL + ("model.attention_window=16",)),
        32, 0, "(c) window 16")
    del params


def serve_cli_phase(torch, arch, smi, overrides=()):
    """``launch.serve.main --arch ARCH`` at full width at the reference
    CLI's defaults (batch 8, prompt 64, 16 new tokens) with
    ``--telemetry-dir``: one valid ``serve_decode`` record a step, the
    cache's length and the tokens' shape; prints its times and peak
    memory (the parameters' init included).  ``overrides`` (a depth cut)
    ride the command line."""
    import shutil
    import tempfile

    from repro_torch.launch.serve import main as serve_main
    from repro_torch.obs import validate_record

    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="serve_smoke_", dir=ROOT / "build"))
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = serve_main(["--arch", arch, "--telemetry-dir", str(d),
                          *overrides])
        with open(d / "telemetry.jsonl") as f:
            records = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    check(out["telemetry_records"] == 16 and len(records) == 16
          and [r["round"] for r in records] == list(range(16))
          and all(r["kind"] == "serve_decode" and validate_record(r) == []
                  for r in records), f"serve {arch}: records {records}")
    check(out["length"] == 64 + 16 and tuple(out["tokens"].shape) == (8, 17),
          f"serve {arch}: length {out['length']}, tokens "
          f"{tuple(out['tokens'].shape)}")
    print(json.dumps({"serve": f"(a) launch.serve.main --arch {arch} "
                               "--telemetry-dir (batch 8, prompt 64, 16 new)"
                               + "".join(f" {o}" for o in overrides),
                      **{k: out[k] for k in ("prefill_ms", "decode_ms",
                                             "tok_s", "max_memory_allocated")},
                      "records": len(records),
                      "latency_s_median": sorted(
                          r["latency_s"] for r in records)[8],
                      "note": "with telemetry each step synchronizes; "
                              "prefill_ms includes the first calls",
                      "card": smi}))


def zoo_serve_phase(torch, get_config, apply_overrides, build_model, smi):
    """Serving the zoo's dense models at full width, a dtype per leaf:
    qwen2.5-14b (bfloat16 weights, float32 rmsnorm scales, QKV bias, 40/8
    GQA, rope theta 10^6; D = 14,770,033,664, 29.54 GB) through
    ``launch.serve.main`` at the CLI's defaults, then its long-context cell
    QWEN_LONG (``serve_cell``: no synchronizing call in decode, bounds from
    ``utils.flops`` on ``utils.roofline``), then a reduced float32
    qwen2.5-14b on the card against the CPU; yi-9b (D = 8,829,407,232,
    17.66 GB) through ``launch.serve.main`` at the CLI's defaults."""
    from repro_torch.configs import reduced
    from repro_torch.configs.shapes import SHAPES

    cfg = get_config("qwen2.5-14b")
    model = build_model(cfg)
    layout = model.param_shapes
    m = cfg.model
    check(model.num_params == QWEN_D and m.qkv_bias and m.dtype == "bfloat16"
          and (m.n_heads, m.n_kv_heads) == (40, 8)
          and layout.buffer_dtypes == (torch.bfloat16, torch.float32),
          f"qwen2.5-14b: {layout}, {m}")
    print(json.dumps({"zoo_layout": cfg.model.name, "D": model.num_params,
                      "buffers": [[str(dt)[6:], n] for dt, n in zip(
                          layout.buffer_dtypes, layout.buffer_sizes)],
                      "float32_leaves": float32_leaves(torch, model),
                      "param_bytes": sum(dt.itemsize * n for dt, n in zip(
                          layout.buffer_dtypes, layout.buffer_sizes))}))
    serve_cli_phase(torch, "qwen2.5-14b", smi)
    torch.cuda.empty_cache()
    params = model.init(0)
    q = QWEN_LONG
    serve_cell(torch, model, params, cfg, q["batch"], q["prompt"],
               q["max_len"], "(qwen b) long context",
               dataclasses.replace(SHAPES["prefill_32k"],
                                   global_batch=q["batch"], seq_len=q["prompt"]),
               dataclasses.replace(SHAPES["decode_32k"],
                                   global_batch=q["batch"],
                                   seq_len=q["max_len"]), smi, profile=True)
    del params
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(cfg), ("model.dtype=float32",)), 32, 40, "max_len 40")
    yi = build_model(get_config("yi-9b"))
    check(yi.num_params == YI_D, f"yi-9b: {yi.param_shapes}")
    serve_cli_phase(torch, "yi-9b", smi)


def recurrent_serve_phase(torch, get_config, apply_overrides, build_model,
                          smi, arch):
    """Serving a recurrent family at full width (rwkv6-7b: D =
    7,576,756,224, its S, x_tm and x_cm states; recurrentgemma-2b: D =
    3,549,934,080, RG-LRU states and the local-attention layers' 2,048-slot
    ring): (a) ``launch.serve.main`` at the CLI's defaults with
    ``--telemetry-dir``; (b) long_500k natively (``for_shape`` adds no
    window) at its batch of 1, a RECURRENT_PROMPT-token prompt and 64
    decode steps through ``serve_cell`` (no synchronizing call in decode,
    the cache's bytes a sequence RECURRENT_CACHE_BYTES at this context and
    at twice it, bounds from ``utils.flops`` on ``utils.roofline``, a
    profiled decode step); rwkv6-7b's prefill memory flat in the prompt
    (``rwkv_prefill_memory_check``); then the reduced float32 model
    (RECURRENT_SERVE_SMALL) on the card against the CPU
    (``serve_reference_check``)."""
    from repro_torch.configs import for_shape, reduced
    from repro_torch.configs.shapes import SHAPES, InputShape

    cfg = for_shape(get_config(arch), SHAPES["long_500k"])
    check(cfg.model.attention_window == 0 and cfg.train.global_batch == 1,
          f"{arch} on long_500k: {cfg.model}")
    model = build_model(cfg)
    check(model.num_params == RECURRENT_FULL_DS[arch],
          f"{arch}: {model.param_shapes}")
    meta = model.init_cache(1, 524_288, device="meta")
    state = sum(v.nbytes for k, v in meta.items() if k != "length")
    check(state == RECURRENT_CACHE_BYTES[arch],
          f"{arch}: {state} cache bytes a sequence at 524,288 tokens")
    print(json.dumps({"recurrent_layout": arch, "D": model.num_params,
                      "kinds": sorted(set(model.kinds)),
                      "buffers": [[str(dt)[6:], n] for dt, n in zip(
                          model.param_shapes.buffer_dtypes,
                          model.param_shapes.buffer_sizes)],
                      "float32_leaves": len(float32_leaves(torch, model)),
                      "cache_bytes_per_sequence_at_524288": state,
                      "cache_shapes": {k: list(v.shape)
                                       for k, v in meta.items()}}))
    serve_cli_phase(torch, arch, smi)
    torch.cuda.empty_cache()
    params = model.init(0)
    P = RECURRENT_PROMPT[arch]
    serve_cell(torch, model, params, cfg, 1, P, 0,
               f"({arch} b) long_500k native",
               InputShape("long_500k_prompt", P, 1, "prefill"),
               SHAPES["long_500k"], smi, profile=True)
    del params
    torch.cuda.empty_cache()
    if arch == RWKV:
        rwkv_prefill_memory_check(torch, get_config, apply_overrides,
                                  build_model, smi)
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(get_config(arch)),
        ("model.dtype=float32",) + RECURRENT_SERVE_SMALL[arch]), 32, 40,
        "max_len 40")


def rwkv_prefill_memory_check(torch, get_config, apply_overrides,
                              build_model, smi):
    """rwkv6-7b at full width and 2 of its 32 layers: prefill of 1 x
    RWKV_PREFILL_PROMPTS tokens, each prompt's peak memory above what was
    allocated before it (the parameters, the prompt).  The prefill runs
    ``models.transformer.PREFILL_CHUNK`` tokens at a time, so the peaks
    differ by less than PREFILL_FLAT_BYTES; a state held a token of the
    whole prompt would take 1 MiB a token a layer (32 GiB a layer at
    32,768).  Prints each prompt's prefill time and peak."""
    from repro_torch.models.transformer import PREFILL_CHUNK

    cfg = apply_overrides(get_config(RWKV), ("model.n_layers=2",))
    model = build_model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    peaks, rows = [], []
    for P in RWKV_PREFILL_PROMPTS:
        toks = torch.randint(0, cfg.model.vocab_size, (1, P), generator=gen,
                             device="cuda", dtype=torch.int32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, toks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(logits).all()) and int(cache["length"]) == P,
              f"rwkv prefill of {P}: logits or length")
        peaks.append(torch.cuda.max_memory_allocated() - base)
        rows.append({"prompt": P, "prefill_ms": ms,
                     "peak_above_params_bytes": peaks[-1]})
        del logits, cache, toks
    print(json.dumps({"rwkv_prefill_memory": f"{RWKV} 2 layers",
                      "chunk": PREFILL_CHUNK, "runs": rows,
                      "growth_bytes": peaks[-1] - peaks[0], "card": smi}))
    check(peaks[-1] - peaks[0] <= PREFILL_FLAT_BYTES,
          f"rwkv prefill memory grows with the prompt: {rows}")
    del params
    torch.cuda.empty_cache()


def float32_fma_phase(torch, ops, tref, build_model, get_config,
                      arch="granite-moe-1b-a400m"):
    """``ops.fma_step_`` on the float32 segment of ``arch`` at the round's
    C = 2 rows: each float32 leaf (granite's norm scales and router, a
    (2, 836,608) buffer; whisper-base's layernorm scales and biases, a
    (2, 32,768) one) a strided view of it, stepped by one launch as the
    local step steps it, ``torch.equal`` to ``fma32`` on the whole
    segment; eta 0.001 rounded to float32.  Returns the largest error."""
    from repro_torch import convert

    model = build_model(get_config(arch))
    leaves = float32_leaves(torch, model)
    seg = convert.Layout.uniform({k: model.param_shapes[k] for k in leaves},
                                 torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(6)
    w = torch.randn((2, seg.numel), generator=gen, device="cuda") * 0.05
    g = torch.randn((2, seg.numel), generator=gen, device="cuda")
    eta = float(torch.tensor(0.001, dtype=torch.float32))
    want = tref.fma32(torch.tensor(-eta, device="cuda"), g, w)
    vw, vg = convert.unflatten_params(w, seg), convert.unflatten_params(g, seg)
    before = ops.LAUNCHES["fma_step"]
    for k in leaves:
        ops.fma_step_(vw[k], vg[k], eta)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["fma_step"] == before + len(leaves),
          f"fma_step on {arch}'s float32 leaves: launches")
    err = _max_diff(w, want)
    check(torch.equal(w, want), f"fma_step on {arch}'s float32 segment "
                                "differs from fma32")
    print(json.dumps({"fma_step_float32_leaves": "torch.equal to fma32",
                      "arch": arch,
                      "rows": 2, "segment": seg.numel, "leaves": leaves,
                      "shapes": [list(vw[k].shape) for k in leaves]}))
    return err


def granite_train_phase(torch, ops, train_main, get_config, apply_overrides,
                        build_model, smi):
    """``launch.train.main --arch granite-moe-1b-a400m`` at full width on
    the 8-device mesh in rsag for 2 steps with ``--checkpoint-dir``
    (every 2) and ``--telemetry-dir``, the counts set to 0 just before and
    read just after (held to ``predicted_cohort_launches`` plus one
    ``fma_step`` a float32 leaf a local step); the checkpoint restored
    into the layout's buffers ``torch.equal`` to the parameters the run
    ended with; both records valid.  Returns the launches."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint as ckpt
    from repro_torch import convert
    from repro_torch.obs import validate_record

    cfg = lm_config(get_config, apply_overrides, GRANITE)
    model = build_model(cfg)
    n32, I = len(float32_leaves(torch, model)), cfg.fl.local_iters
    (ROOT / "build").mkdir(exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="granite_smoke_", dir=ROOT / "build"))
    ck, tel = d / "ckpt", d / "tel"
    argv = ["--arch", GRANITE, "--devices", "8", "--collective", "rsag",
            "--steps", "2", "--log-every", "1", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "2", "--telemetry-dir", str(tel),
            *LM_OVERRIDES]
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = train_main(argv)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        want = {k: 0 for k in ops.LAUNCHES}
        want.update(predicted_cohort_launches("rsag", True, (2,), 0, 2))
        want["fma_step"] += 2 * I * n32
        check(launches == want,
              f"granite trainer: launches {launches} != predicted {want}")
        check(out["kind"] == "fl_round" and out["cohorts"] == 2
              and out["steps"] == 2 and math.isfinite(out["loss"])
              and out["params_finite"], f"granite trainer ran {out}")
        size = os.path.getsize(ck / "ckpt_2.msgpack")
        t0 = time.perf_counter()
        back = ckpt.restore_params(str(ck), model.param_shapes.empty(),
                                   model.param_shapes, step=2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(
            convert.buffers(back), convert.buffers(out["params"]))),
            "granite trainer: the restored checkpoint differs from the run's "
            "parameters")
        del back
        with open(tel / "telemetry.jsonl") as f:
            records = [json.loads(line) for line in f]
        check([r["round"] for r in records] == [0, 1]
              and all(validate_record(r) == [] for r in records),
              f"granite trainer: records {records}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    shown = " ".join({str(ck): "CKPT", str(tel): "TEL"}.get(a, a) for a in argv)
    print(json.dumps({"granite_trainer": shown, **{
        k: out.get(k) for k in ("kind", "mesh", "cohorts", "steps", "loss",
                                "tok_s", "seconds", "save_s",
                                "max_memory_allocated")},
        "checkpoint_bytes": size, "restore_s": restore_s,
        "restored_equal": True, "records": len(records),
        "launches": {k: v for k, v in launches.items() if v}, "card": smi}))
    return launches


def round_update_phase(torch, get_config, tfleet, smi):
    """``round_update`` alone at FLEET_SIZE devices and K = 10 (the first
    fleet run's policies): device time queued behind a sleep, and host time
    through a synchronize; one call under sync debug mode "error"."""
    cfg = fleet_config(paper_config(get_config), FLEET_SIZE,
                       *FLEET_SIM_RUNS[0])
    D, K = 421_642, cfg.fl.devices_per_round
    state = tfleet.init_fleet(0, cfg)
    gen = torch.Generator(device="cuda").manual_seed(4)
    fn = lambda: tfleet.round_update(state, gen, cfg, D, K)
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    queued, late = time_queued_ms(torch, fn)
    host = host_ms(torch, fn)
    print(json.dumps({"timing": "round_update", "fleet_size": FLEET_SIZE,
                      "k": K, "selection": cfg.fleet.selection,
                      "power": cfg.power.policy, "ms_queued": queued,
                      "ms_queued_late": late, "host_ms": host,
                      "ms_queued_is": "device time of one call queued behind "
                                      "a device sleep, L2 flushed, median of 50",
                      "host_ms_is": "median host time of one call through a "
                                    "synchronize",
                      "card": smi}))
    return {"ms_queued": queued, "ms_queued_late": late, "host_ms": host}


def cohort_fleet_phase(torch, ops, get_config, build_model, digit_dataset,
                       make_fl_round, tfleet, smi):
    """The cohort round with a COHORT_FLEET_SIZE-device fleet (rate_aware,
    fbl_target, the IPW scale after the collective) at (10,) and (2, 5) in
    each format of COHORT_FLEET_MODES, COHORT_ROUNDS rounds from the same
    parameters, fleet, batches and generator seed, the counts set to 0
    just before each format's rounds and read just after.  Checks the
    launches against ``predicted_cohort_launches``, loss finite and
    falling, the battery conserved, and parameters and fleet
    ``torch.equal`` across formats and layouts.  Returns the launches."""
    C, I, micro, R = 10, 3, 32, COHORT_ROUNDS
    cfg = fleet_config(cohort_config(get_config, I=I, micro=micro, C=C),
                       COHORT_FLEET_SIZE, "rate_aware", "fbl_target", True)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = digit_dataset(gen, R * C * I * micro)
    batches = [{k: v[r * C * I * micro:(r + 1) * C * I * micro]
                for k, v in data.items()} for r in range(R)]
    params0 = torch.cat([v.reshape(-1) for _, v in sorted(model.init(1).items())])
    fleet0 = tfleet.init_fleet(4, cfg)
    total = {k: 0 for k in ops.LAUNCHES}
    results = {}
    for sizes in ((C,), (2, 5)):
        for mode in COHORT_FLEET_MODES:
            fn = make_fl_round(model, cfg, sizes, collective=mode)
            g = torch.Generator(device="cuda").manual_seed(11)
            params, fleet, hist, ms = params0, fleet0, [], []
            ops.reset_launch_counts()
            for r in range(R):
                t0 = time.perf_counter()
                params, m, fleet = fn(params, batches[r], g, fleet)
                loss = float(m["loss"])              # waits for the round
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                hist.append({k: float(m[k]) for k in
                             ("survivors", "selected_valid", "cohort_energy_j",
                              "harvested_j", "outage_rate")} | {"loss": loss})
            launches = dict(ops.LAUNCHES)
            for k, v in launches.items():
                total[k] += v
            want = {k: 0 for k in ops.LAUNCHES}
            want.update(predicted_cohort_launches(
                mode, True, sizes, I if model.quantizes_training else 0, R))
            what = f"fleet cohort round {sizes} {mode}"
            check(launches == want, f"{what}: launches {launches} != {want}")
            losses = [h["loss"] for h in hist]
            check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
                  f"{what}: loss {losses}")
            check(all(h["selected_valid"] == C for h in hist),
                  f"{what}: cohort not filled {hist}")
            check_battery(torch, fleet0.battery_j, fleet.battery_j,
                          sum(h["cohort_energy_j"] for h in hist),
                          sum(h["harvested_j"] for h in hist), what)
            results[sizes, mode] = params, fleet
            print(json.dumps({"fleet_cohort_round": mode,
                              "axis_sizes": list(sizes), "C": C, "I": I,
                              "fleet_size": COHORT_FLEET_SIZE,
                              "error_reweight": True, "losses": losses,
                              "survivors": [h["survivors"] for h in hist],
                              "outage_rate": [h["outage_rate"] for h in hist],
                              "round_ms": ms,
                              "round_ms_median": sorted(ms)[R // 2],
                              "launches": {k: v for k, v in launches.items() if v},
                              "card": smi}))
    p_ref, f_ref = results[(C,), "int"]
    for key, (p, f) in results.items():
        check(torch.equal(p, p_ref), f"fleet cohort {key}: params differ from int")
        for name in tfleet.FleetState._fields:
            check(torch.equal(getattr(f, name), getattr(f_ref, name)),
                  f"fleet cohort {key}: fleet.{name} differs from int")
    print(f"fleet cohort round: params and fleet torch.equal across "
          f"{', '.join(COHORT_FLEET_MODES)} after {R} rounds at (10,) and "
          f"(2, 5); launches as predicted")
    fn = make_fl_round(model, cfg, (C,), collective="rsag")
    g = torch.Generator(device="cuda").manual_seed(3)
    profile_phase(torch, f"make_fl_round rsag (10,) fleet {COHORT_FLEET_SIZE:,}",
                  lambda: fn(params0, batches[0], g, fleet0))
    for mode in COHORT_FLEET_MODES:
        fn = make_fl_round(model, cfg, (C,), collective=mode)
        spans_phase(torch, f"make_fl_round {mode} (10,) fleet "
                           f"{COHORT_FLEET_SIZE:,}",
                    lambda: fn(params0, batches[0], g, fleet0),
                    WIRE_SPANS[mode])
    return total


def spans_phase(torch, label, run_round, wire):
    """One round traced with CPU and CUDA activity holds every span of
    ``wire`` (the wire phases its format runs), every ``fleet/*`` phase and
    both ``fl/*`` phases, and no other wire phase; prints each span's host
    time (its range on the host) and device span (the ranges the profiler
    puts on the card's timeline for it, summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    run_round()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_round()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.name.split("/")[0] not in ("wire", "fleet", "fl"):
            continue
        d = spans.setdefault(e.name, {"host_ms": 0.0, "device_span_ms": 0.0,
                                      "calls": 0})
        if e.device_type == DeviceType.CPU:
            d["host_ms"] += e.time_range.elapsed_us() / 1e3
            d["calls"] += 1
        else:
            d["device_span_ms"] += e.time_range.elapsed_us() / 1e3
    want = set(wire) | set(trace.FLEET_PHASES) | set(trace.FL_PHASES)
    have = {k for k, d in spans.items() if d["calls"]}
    check(want <= have, f"{label}: spans missing {sorted(want - have)}")
    check(not set(spans) - want, f"{label}: spans {sorted(set(spans) - want)} "
                                 f"its format does not run")
    print(json.dumps({"spans": label, "phases": dict(sorted(spans.items()))}))


#: the LM path: olmo-1b at full width on the reference's (2, 4) debug mesh
#: for 8 devices (C = 2 cohorts stacked, I = 3), cut to 12 sequences of
#: 512 tokens a round (the config's 256 x 4,096) so that two stacked
#: replicas fit one card; width and C are never cut
#: the distributed cohort round (one cohort a process over ``core.comm``):
#: DIST_WORLD worker processes share cuda:0 over gloo with host staging.
#: The QNN at the paper's width (I = 3, 32 images a microbatch, q = 0.01)
#: on each mesh of DIST_MESHES in each of DIST_FORMATS (label, collective,
#: pipeline_hops); reduced olmo-1b (one bfloat16 buffer) and reduced
#: qwen2.5-14b (a bfloat16 and a float32 buffer) at (2,) over 2 ranks in
#: DIST_LM_FORMATS
DIST_WORLD = 4
DIST_MESHES = (((4,), ("data",)), ((2, 2), ("pod", "data")),
               ((2, 2), ("data", "model")))
DIST_FORMATS = (("paper", "paper", True), ("int", "int", True),
                ("packed", "packed", True), ("ring", "ring", True),
                ("ring_sequential", "ring", False), ("rsag", "rsag", True),
                ("rsag_sequential", "rsag", False))
DIST_LM_FORMATS = (("ring", "ring", True), ("rsag", "rsag", True))
DIST_LM = ("olmo-1b", "qwen2.5-14b")
DIST_LM_OVERRIDES = ("model.dtype=bfloat16", "train.global_batch=8",
                     "train.seq_len=64", "fl.local_iters=2",
                     "channel.error_prob=0.3")
#: the wire kernels of the per-rank uplink, each with its plain version,
#: held to each other on every call of one round a format
DIST_HELD = (("stochastic_quantize_codes", "stochastic_quantize_ref"),
             ("dequantize_codes", "dequantize_ref"),
             ("quantize_pack", "quantize_pack_ref"),
             ("quantize_pack_chunk", "quantize_pack_chunk_ref"),
             ("pack_sums", "pack_sums_ref"), ("repack", "repack_ref"),
             ("unpack_dequantize", "unpack_dequantize_ref"))


def _digest(torch, flat) -> str:
    import hashlib
    h = hashlib.sha256()
    for b in (flat if isinstance(flat, tuple) else (flat,)):
        h.update(b.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


def _flat32(torch, flat):
    return torch.cat([b.float().reshape(-1) for b in
                      (flat if isinstance(flat, tuple) else (flat,))])


def _dist_inputs(torch, model_name, C, dev):
    """(the config for a pipeline_hops, model, round batches, params) of
    one job, the same on every rank."""
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import digit_dataset, token_batch
    from repro_torch.models import build_model

    if model_name == "qnn":
        I, micro = 3, 32
        make_cfg = lambda hops: cohort_config(get_config, hops, I=I,
                                              micro=micro, C=C)
        model = build_model(make_cfg(True))
        gen = torch.Generator(device=dev).manual_seed(0)
        B = C * I * micro
        data = digit_dataset(gen, COHORT_ROUNDS * B)
        batches = [{k: v[r * B:(r + 1) * B] for k, v in data.items()}
                   for r in range(COHORT_ROUNDS)]
        params = torch.cat([v.reshape(-1) for _, v in
                            sorted(model.init(1, device=dev).items())])
        return make_cfg, model, batches, params
    cfg = apply_overrides(reduced(get_config(model_name)), DIST_LM_OVERRIDES)
    make_cfg = lambda hops: dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, pipeline_hops=hops))
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(5)
    batches = [token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                           cfg.model.vocab_size) for _ in range(COHORT_ROUNDS)]
    return make_cfg, model, batches, model.init_flat(1, device=dev)


def _held_to_plain(torch, ops, tref, seen):
    """Replace each kernel wrapper of DIST_HELD in ``ops`` by one that
    also runs its plain version in ``tref`` on copies of the same operands
    on the card (before the kernel, which may write an operand in place)
    and adds to ``seen[name]``: the calls, the operand shapes, whether
    every output was ``torch.equal`` and the largest absolute difference.
    Returns the function that puts the wrappers back."""
    saved = {name: getattr(ops, name) for name, _ in DIST_HELD}

    def held(name, kernel, plain):
        def call(*args, **kw):
            want = plain(*(a.detach().clone() if isinstance(a, torch.Tensor)
                           else a for a in args), **kw)
            got = kernel(*args, **kw)
            rec = seen.setdefault(name, {"calls": 0, "equal": True,
                                         "max_abs_err": 0.0, "shapes": []})
            rec["calls"] += 1
            shapes = [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            if shapes not in rec["shapes"]:
                rec["shapes"].append(shapes)
            pairs = (zip(got, want) if isinstance(got, tuple)
                     else ((got, want),))
            for g, w in pairs:
                rec["equal"] &= bool(torch.equal(g, w))
                if g.numel():
                    rec["max_abs_err"] = max(rec["max_abs_err"], float(
                        (g.double() - w.double()).abs().max()))
            return got
        return call

    for name, plain in DIST_HELD:
        setattr(ops, name, held(name, saved[name], getattr(tref, plain)))

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)
    return restore


def dist_worker(rank, world, init, jobs):
    """One rank of ``dist_phase`` on cuda:0 over gloo.  For each job
    (model, mesh shape, axes, formats): COHORT_ROUNDS rounds a format from
    one generator, timed, the launch counts set to 0 just before and read
    just after; then one round a format with every wire kernel held to
    its plain version at this rank's operands (``_held_to_plain``); then
    one round a format against the stacked round on this card from the
    same draws (``dist_round_noise``); then the per-rank aggregate of the
    stacked round's own (C, D) rows against ``aggregate``.  Returns host
    values only."""
    import torch
    from repro_torch.core import aggregation as agg
    from repro_torch.core import comm as comm_mod
    from repro_torch.core.fl import (_cohort_batches, _delta,
                                     dist_round_noise, local_sgd,
                                     make_dist_fl_round, make_fl_round)
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as tref
    from repro_torch.launch import mesh as tmesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    comm_mod.init_process_group("gloo", rank, world, dev, init_method=init)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    results = []
    try:
        for model_name, shape, axes, formats in jobs:
            comm = comm_mod.Comm(tmesh.make_mesh(shape, axes), ("pod", "data"),
                                 dev)
            C = comm.num_cohorts
            make_cfg, model, batches, params0 = _dist_inputs(torch, model_name,
                                                             C, dev)
            params0 = comm.broadcast_(params0)
            D = model.param_shapes.numel
            n32 = sum(1 for k in model.param_shapes
                      if model.param_shapes.dtypes[k] == torch.float32)
            res = {"model": model_name, "shape": shape, "axes": axes, "C": C,
                   "D": D, "layout": repr(model.param_shapes),
                   "cohort": comm.cohort, "formats": {},
                   "fma_per_round": (0 if model_name == "qnn" else
                                     n32 * make_cfg(True).fl.local_iters)}
            # warm-up (cuDNN's first calls), outside the counted rounds
            make_dist_fl_round(model, make_cfg(True), comm, collective="int")(
                params0, batches[0], seeded(99))
            torch.cuda.synchronize()
            for label, collective, hops in formats:
                fn = make_dist_fl_round(model, make_cfg(hops), comm,
                                        collective=collective)
                g, params, hist = seeded(11), params0, []
                staged0 = comm.staging_s
                ops.reset_launch_counts()
                for r in range(COHORT_ROUNDS):
                    t0 = time.perf_counter()
                    params, m = fn(params, batches[r], g)
                    loss = float(m["loss"])              # waits for the round
                    torch.cuda.synchronize()
                    hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                                 "loss": loss,
                                 "survivors": float(m["survivors"]),
                                 "digest": _digest(torch, params),
                                 "finite": bool(torch.isfinite(
                                     _flat32(torch, params)).all())})
                res["formats"][label] = {
                    "collective": collective, "hops": hops, "rounds": hist,
                    "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
                    "staging_ms": (comm.staging_s - staged0) * 1e3
                                  / COHORT_ROUNDS,
                    "wire_bits": m["wire_bits_per_param"]}
            for label, collective, hops in formats:
                seen = {}
                restore = _held_to_plain(torch, ops, tref, seen)
                try:
                    make_dist_fl_round(model, make_cfg(hops), comm,
                                       collective=collective)(
                        params0, batches[0], seeded(11))
                    torch.cuda.synchronize()
                finally:
                    restore()
                res["formats"][label]["plain"] = seen
            for label, collective, hops in formats:
                cfg = make_cfg(hops)
                got, gm = make_dist_fl_round(model, cfg, comm,
                                             collective=collective)(
                    params0, batches[0], seeded(21))
                want, wm = make_fl_round(model, cfg, comm.axis_sizes,
                                         collective=collective, device=dev)(
                    params0, batches[0],
                    noise=dist_round_noise(model, cfg, seeded(21), C, D))
                a, b = _flat32(torch, got), _flat32(torch, want)
                diff = (a - b).abs()
                res["formats"][label]["vs_stacked"] = {
                    "equal": bool(torch.equal(a, b)),
                    "max_diff": float(diff.max()),
                    "within_1e-5": float((diff <= 1e-5).float().mean()),
                    "equal_share": float((diff == 0).float().mean()),
                    "ulp_bound": bool((diff <= 1 / 128 + b.abs() * 2 ** -7)
                                      .all()),
                    "loss": float(gm["loss"]), "stacked_loss": float(wm["loss"])}
            cfg = make_cfg(True)
            nz = dist_round_noise(model, cfg, seeded(31), C, D)
            local, _, _ = local_sgd(model, cfg, params0, _cohort_batches(
                batches[0], C, cfg.fl.local_iters, slice(None)),
                u_train=nz.u_train)
            rows = _delta(local, params0, model.param_shapes)
            lam = torch.ones(C, device=dev)
            lam[1] = 0.0
            k = comm.cohort
            for label, collective, hops in formats:
                plan = agg.make_wire_plan(collective, make_cfg(hops).quant,
                                          comm.axes, comm.axis_sizes)
                got = agg.aggregate_rank(plan, comm, rows[k:k + 1], 1.0 / C,
                                         lam[k:k + 1], nz.u_up[k:k + 1])
                want = agg.aggregate(plan, rows, 1.0 / C, lam, nz.u_up)
                res["formats"][label]["aggregate"] = {
                    "equal": bool(torch.equal(got, want)),
                    "rel": float((got - want).abs().max()
                                 / want.abs().max().clamp(min=1e-30))}
            res["sent"] = dict(comm.sent)
            results.append(res)
        return results
    finally:
        comm_mod.destroy_process_group()


def dist_phase(torch, run_ranks, smi):
    """The distributed cohort round: 4 worker processes (``spawn``) on
    cuda:0 over gloo with host staging, the kernels already built; then 2
    for the reduced LMs.  A worker that fails, hangs or is killed fails the
    phase.  Checks every rank's parameters ``torch.equal`` after every
    round, the quantized formats ``torch.equal`` to each other, the launch
    counts a rank as ``predicted_cohort_launches``, the per-rank aggregate
    ``torch.equal`` to ``aggregate`` on the stacked round's rows (paper
    within rtol 1e-6 of the largest value), and the round against the
    stacked round on the same draws: ``torch.equal`` or ROADMAP C4's bound
    (printed which); and every call of a wire kernel in one round a format
    ``torch.equal`` to its plain version at the rank's own operands, each
    kernel the counted rounds launched among them.  Returns the launches
    summed over ranks and rounds, and each wire kernel's largest
    difference from its plain version."""
    from repro_torch.core import comm as tcomm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = ROOT / "build" / f"dist_smoke_{int(time.time() * 1e3)}"
    runs = [run_ranks(dist_worker, DIST_WORLD,
                      ([("qnn", s, a, DIST_FORMATS) for s, a in DIST_MESHES],),
                      workdir=str(work / "qnn"),
                      timeout_s=tcomm.TIMEOUT_S),
            run_ranks(dist_worker, 2,
                      ([(m, (2,), ("data",), DIST_LM_FORMATS)
                        for m in DIST_LM],),
                      workdir=str(work / "lm"), timeout_s=tcomm.TIMEOUT_S)]
    total, err = {}, {}
    for ranks in runs:
        for j, res0 in enumerate(ranks[0]):
            shape, model_name = tuple(res0["shape"]), res0["model"]
            sizes = tuple(s for s, a in zip(shape, res0["axes"])
                          if a != "model")
            where = f"{model_name} {shape} {res0['axes']}"
            digests = {}
            for label, f0 in res0["formats"].items():
                per_rank = [r[j]["formats"][label] for r in ranks]
                for r in range(COHORT_ROUNDS):
                    check(len({p["rounds"][r]["digest"] for p in per_rank}) == 1,
                          f"{where} {label} round {r}: replicas differ")
                check(all(h["finite"] and math.isfinite(h["loss"])
                          for p in per_rank for h in p["rounds"]),
                      f"{where} {label}: non-finite")
                digests[label] = [h["digest"] for h in f0["rounds"]]
                qnn = model_name == "qnn"
                want = predicted_cohort_launches(
                    f0["collective"], f0["hops"], sizes, 3 if qnn else 0,
                    COHORT_ROUNDS)
                if res0["fma_per_round"]:
                    want["fma_step"] = res0["fma_per_round"] * COHORT_ROUNDS
                for p in per_rank:
                    check(p["launches"] == want,
                          f"{where} {label}: launches {p['launches']} != "
                          f"predicted {want}")
                    for k, v in p["launches"].items():
                        total[k] = total.get(k, 0) + v
                    plain = p["plain"]
                    check(all(plain[k]["calls"] for k in p["launches"]
                              if k in dict(DIST_HELD)),
                          f"{where} {label}: a launched wire kernel was not "
                          f"held to its plain version: {sorted(plain)}")
                    for k, rec in plain.items():
                        check(rec["equal"], f"{where} {label}: {k} differs "
                              f"from its plain version at {rec['shapes']}")
                        err[k] = max(err.get(k, 0.0), rec["max_abs_err"])
                aggs = [p["aggregate"] for p in per_rank]
                if f0["collective"] == "paper":
                    check(all(a["rel"] <= 1e-6 for a in aggs),
                          f"{where} {label}: aggregate off by {aggs}")
                else:
                    check(all(a["equal"] for a in aggs),
                          f"{where} {label}: aggregate != the stacked one")
                vs = [p["vs_stacked"] for p in per_rank]
                exact = all(v["equal"] for v in vs)
                # ROADMAP C4's bound; in bfloat16 that of the LM round's
                # CPU test: a code step and an ulp, 99 % equal
                for v in vs:
                    if qnn:
                        ok = (v["max_diff"] <= 1 / 128 + 1e-7
                              and v["within_1e-5"] >= 0.999
                              and abs(v["loss"] - v["stacked_loss"])
                              <= 1e-4 * abs(v["stacked_loss"]))
                    else:
                        ok = (v["ulp_bound"] and v["equal_share"] >= 0.99
                              and abs(v["loss"] - v["stacked_loss"])
                              <= 1e-3 * abs(v["stacked_loss"]))
                    check(ok, f"{where} {label}: round vs stacked {v}")
                ms = sorted(max(p["rounds"][r]["ms"] for p in per_rank)
                            for r in range(COHORT_ROUNDS))
                print(json.dumps({
                    "dist_round": label, "model": model_name,
                    "mesh": list(shape), "axes": list(res0["axes"]),
                    "ranks": len(ranks), "backend": "gloo, host staging",
                    "cohorts": res0["C"], "D": res0["D"],
                    "round_ms_median": ms[COHORT_ROUNDS // 2],
                    "round_ms": ms,
                    "staging_ms_per_round": max(p["staging_ms"]
                                                for p in per_rank),
                    "launches_per_round_rank0": {
                        k: v / COHORT_ROUNDS for k, v in f0["launches"].items()},
                    "wire_bits_per_param": f0["wire_bits"],
                    "losses": [h["loss"] for h in f0["rounds"]],
                    "vs_stacked": "torch.equal" if exact else (
                        "C4 bound" if qnn else "bfloat16 bound, 99 % equal"),
                    "vs_stacked_max_diff": max(v["max_diff"] for v in vs),
                    "aggregate_vs_stacked": ("rtol 1e-6" if f0["collective"]
                                             == "paper" else "torch.equal"),
                    "plain_max_abs_err": max(
                        (rec["max_abs_err"] for p in per_rank
                         for rec in p["plain"].values()), default=0.0),
                    "plain_shapes_rank0": {
                        k: rec["shapes"] for k, rec in f0["plain"].items()},
                    "card": smi}))
            quantized = [l for l in digests
                         if res0["formats"][l]["collective"] != "paper"]
            for l in quantized:
                check(digests[l] == digests[quantized[0]],
                      f"{where}: {l} params differ from {quantized[0]}")
            print(f"dist round {where}: replicas torch.equal after every "
                  f"round on {len(ranks)} ranks; {', '.join(quantized)} "
                  f"torch.equal to each other; layout {res0['layout']}")
    print(f"dist phase: {time.perf_counter() - t0:.1f} s  ({smi})")
    return total, err


#: the tensor-parallel round (``tp_phase``): TP_WORLD workers on cuda:0
#: over gloo with host staging.  olmo-1b at full width (d_model 2,048, 16
#: heads, vocab 50,304, tied) cut to TP_OLMO_LAYERS of its 16 layers:
#: every rank holds one round a format its wire kernels' plain versions'
#: int64 temporaries at (1, D_local) beside the kernels' outputs, 4 ranks
#: at once on the card, and rank 0 the stacked round of the whole cut
#: beside them; at (1, 4) and (2, 2) over ("data", "model") in
#: TP_FORMATS; and reduced qwen2.5-14b (bfloat16 weights, float32 norms,
#: its q/k/v biases) at (1, 4).  TP_ROUNDS rounds a format.
TP_WORLD = 4
TP_OLMO_LAYERS = 4
TP_FORMATS = ("int", "packed", "rsag")
TP_ROUNDS = 2
#: (arch, whether reduced, the cut, mesh shape over ("data", "model"))
TP_JOBS = (("olmo-1b", False, (f"model.n_layers={TP_OLMO_LAYERS}",), (1, 4)),
           ("olmo-1b", False, (f"model.n_layers={TP_OLMO_LAYERS}",), (2, 2)),
           ("qwen2.5-14b", True, (), (1, 4)))


def tp_config(arch, small, cut):
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config, reduced

    cfg = get_config(arch)
    return apply_overrides(reduced(cfg) if small else cfg,
                           DIST_LM_OVERRIDES + tuple(cut))


def tp_worker(rank, world, init, jobs):
    """One rank of ``tp_phase`` on cuda:0 over gloo.  For each job (arch,
    whether reduced, cut, mesh shape): the model placed on this rank
    (``sharding.placement.place_model``), its blocks built from the seed
    and broadcast over the cohort group; its parameter bytes against
    ``sharding.rules.bytes_per_device``; TP_ROUNDS rounds a format from one
    generator, timed, the launch counts set to 0 just before and read just
    after, the parameters gathered over the model group after the first
    (outside the timer); one round a format with every wire kernel held to
    its plain version at this rank's operands (``_held_to_plain``); and on
    rank 0, the stacked round of the whole model from the same parameters
    and draws (``dist_round_noise``) against the gathered first round.
    Returns host values only."""
    import torch
    from repro_torch import convert
    from repro_torch.core import comm as comm_mod
    from repro_torch.core.fl import (dist_round_noise, make_dist_fl_round,
                                     make_fl_round)
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as tref
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.placement import gather_block, place_model

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    comm_mod.init_process_group("gloo", rank, world, dev, init_method=init)
    seeded = lambda s: torch.Generator(device=dev).manual_seed(s)
    results = []
    try:
        for arch, small, cut, shape in jobs:
            mesh = tmesh.make_mesh(shape, ("data", "model"))
            comm = comm_mod.Comm(mesh, ("pod", "data"), dev)
            C = comm.num_cohorts
            cfg = tp_config(arch, small, cut)
            model = build_model(cfg)
            placed = place_model(model, cfg, comm)
            check(placed is not model, f"{arch} {shape}: nothing placed")
            specs = placed.placement.specs
            params0 = comm.broadcast_(placed.init_flat(1, device=dev))
            gen = seeded(5)
            batches = [token_batch(gen, cfg.train.global_batch,
                                   cfg.train.seq_len, cfg.model.vocab_size)
                       for _ in range(TP_ROUNDS)]
            res = {"arch": arch + ("-reduced" if small else ""),
                   "cut": list(cut), "shape": shape, "C": C,
                   "D": model.param_shapes.numel,
                   "D_local": placed.param_shapes.numel,
                   "sharded": sorted(k for k, v in specs.items()
                                     if rules.model_dim(v) is not None),
                   "param_bytes": sum(b.nbytes for b in
                                      convert.buffers(params0)),
                   "bytes_per_device": rules.bytes_per_device(
                       model.param_shapes, specs, mesh),
                   "layout": repr(placed.param_shapes), "formats": {}}
            # warm-up (cuBLAS's first calls), outside the counted rounds
            make_dist_fl_round(placed, cfg, comm, collective="int")(
                params0, batches[0], seeded(99))
            torch.cuda.synchronize()
            gathered = {}
            for fmt in TP_FORMATS:
                fn = make_dist_fl_round(placed, cfg, comm, collective=fmt)
                g, params, hist = seeded(11), params0, []
                staged0, model0 = comm.staging_s, comm.model_staging_s
                sent0 = comm.sent["model"]
                torch.cuda.reset_peak_memory_stats()
                ops.reset_launch_counts()
                for r in range(TP_ROUNDS):
                    t0 = time.perf_counter()
                    params, m = fn(params, batches[r], g)
                    loss = float(m["loss"])              # waits for the round
                    torch.cuda.synchronize()
                    hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                                 "loss": loss, "finite": bool(torch.isfinite(
                                     _flat32(torch, params)).all())})
                    if r == 0:
                        first = params
                launches = {k: v for k, v in ops.LAUNCHES.items() if v}
                res["formats"][fmt] = {
                    "rounds": hist, "launches": launches,
                    "wire_bits": m["wire_bits_per_param"],
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "staging_ms": (comm.staging_s - staged0) * 1e3 / TP_ROUNDS,
                    "model_staging_ms": (comm.model_staging_s - model0) * 1e3
                                        / TP_ROUNDS,
                    "model_bytes": (comm.sent["model"] - sent0) / TP_ROUNDS}
                # the first round's parameters gathered over the model
                # group (no kernel), outside the counted window
                leaves = convert.unflatten_params(first, placed.param_shapes)
                whole = {k: gather_block(placed, k, v)
                         for k, v in leaves.items()}
                if rank == 0:       # kept on the host: out of the peaks
                    gathered[fmt] = convert.map_buffers(
                        lambda b: b.cpu(), convert.flatten_params(whole))
                del whole, leaves, first
            for fmt in TP_FORMATS:
                seen = {}
                restore = _held_to_plain(torch, ops, tref, seen)
                try:
                    make_dist_fl_round(placed, cfg, comm, collective=fmt)(
                        params0, batches[0], seeded(11))
                    torch.cuda.synchronize()
                finally:
                    restore()
                res["formats"][fmt]["plain"] = seen
            del params0, params
            torch.cuda.empty_cache()
            if rank == 0:
                # the stacked round of the whole cut, alone on the card but
                # for the other ranks' blocks, from the same init and draws
                full0 = model.init_flat(1, device=dev)
                for fmt in TP_FORMATS:
                    torch.cuda.reset_peak_memory_stats()
                    want, wm = make_fl_round(model, cfg, comm.axis_sizes,
                                             collective=fmt, device=dev)(
                        full0, batches[0], noise=dist_round_noise(
                            model, cfg, seeded(11), C, res["D"]))
                    torch.cuda.synchronize()
                    a = _flat32(torch, gathered.pop(fmt)).to(dev)
                    b = _flat32(torch, want)
                    diff = (a - b).abs()
                    # a code step and a bfloat16 ulp of the larger value: a
                    # code flip near 0 lands in a larger binade
                    over = diff > 1 / 128 + torch.maximum(a.abs(), b.abs()) \
                        * 2 ** -7
                    res["formats"][fmt]["vs_stacked"] = {
                        "equal_share": float((diff == 0).float().mean()),
                        "max_diff": float(diff.max()),
                        "ulp_bound": not bool(over.any()),
                        "over_stacked_ulp_bound": int((
                            diff > 1 / 128 + b.abs() * 2 ** -7).sum()),
                        "loss": res["formats"][fmt]["rounds"][0]["loss"],
                        "stacked_loss": float(wm["loss"]),
                        "stacked_peak_bytes":
                            torch.cuda.max_memory_allocated()}
                    del want, a, b, diff, over
                del full0
            comm.barrier()
            torch.cuda.empty_cache()
            res["model_sent"] = comm.sent["model"]
            results.append(res)
        return results
    finally:
        comm_mod.destroy_process_group()


def tp_phase(torch, run_ranks, smi):
    """The distributed round tensor-parallel over "model": TP_WORLD worker
    processes (``spawn``) on cuda:0 over gloo with host staging, the
    kernels already built, one spawn for TP_JOBS.  A worker that fails,
    hangs or is killed fails the phase.  Checks each rank's parameter
    bytes equal ``sharding.bytes_per_device``; finite losses, the same on
    every rank; the quantized formats' gathered parameters after the first
    round against the stacked round on the same draws at the bfloat16
    bound of ``dist_phase`` (a code step and a bfloat16 ulp, here of the
    larger of the two values, 99 % equal), the loss within 1e-3;
    and every call of a wire kernel in one round a format ``torch.equal``
    to its plain version at the rank's own operands, each kernel the
    counted rounds launched among them.  Returns the launches summed over
    ranks and counted rounds, and each wire kernel's largest difference
    from its plain version."""
    from repro_torch.core import comm as tcomm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    work = ROOT / "build" / f"tp_smoke_{int(time.time() * 1e3)}"
    ranks = run_ranks(tp_worker, TP_WORLD, (list(TP_JOBS),),
                      workdir=str(work), timeout_s=tcomm.TIMEOUT_S)
    total, err = {}, {}
    for j, res0 in enumerate(ranks[0]):
        where = f"{res0['arch']} {tuple(res0['shape'])}"
        for r in ranks:
            check(r[j]["param_bytes"] == r[j]["bytes_per_device"],
                  f"{where}: a rank holds {r[j]['param_bytes']} parameter "
                  f"bytes, bytes_per_device {r[j]['bytes_per_device']}")
        for fmt, f0 in res0["formats"].items():
            per_rank = [r[j]["formats"][fmt] for r in ranks]
            check(all(h["finite"] and math.isfinite(h["loss"])
                      for p in per_rank for h in p["rounds"]),
                  f"{where} {fmt}: non-finite")
            check(all(p["rounds"][i]["loss"] == f0["rounds"][i]["loss"]
                      for p in per_rank for i in range(TP_ROUNDS)),
                  f"{where} {fmt}: the loss differs between ranks")
            for p in per_rank:
                check(p["launches"], f"{where} {fmt}: no kernel launched")
                for k, v in p["launches"].items():
                    total[k] = total.get(k, 0) + v
                plain = p["plain"]
                check(all(plain[k]["calls"] for k in p["launches"]
                          if k in dict(DIST_HELD)),
                      f"{where} {fmt}: a launched wire kernel was not held "
                      f"to its plain version: {sorted(plain)}")
                for k, rec in plain.items():
                    check(rec["equal"], f"{where} {fmt}: {k} differs from "
                          f"its plain version at {rec['shapes']}")
                    err[k] = max(err.get(k, 0.0), rec["max_abs_err"])
            v = f0["vs_stacked"]
            check(v["ulp_bound"] and v["equal_share"] >= 0.99
                  and abs(v["loss"] - v["stacked_loss"])
                  <= 1e-3 * abs(v["stacked_loss"]),
                  f"{where} {fmt}: round vs stacked {v}")
            ms = sorted(max(p["rounds"][i]["ms"] for p in per_rank)
                        for i in range(TP_ROUNDS))
            print(json.dumps({
                "tp_round": fmt, "model": res0["arch"], "cut": res0["cut"],
                "mesh": list(res0["shape"]), "axes": ["data", "model"],
                "ranks": len(ranks), "backend": "gloo, host staging",
                "cohorts": res0["C"], "D": res0["D"],
                "D_local": res0["D_local"],
                "param_bytes_per_rank": [r[j]["param_bytes"] for r in ranks],
                "bytes_per_device": res0["bytes_per_device"],
                "peak_bytes_per_rank": [p["peak_bytes"] for p in per_rank],
                "stacked_peak_bytes": v["stacked_peak_bytes"],
                "stacked_cohorts": res0["C"],
                "round_ms": ms, "round_ms_first": ms[0] if TP_ROUNDS else None,
                "staging_ms_per_round": max(p["staging_ms"] for p in per_rank),
                "model_staging_ms_per_round": max(p["model_staging_ms"]
                                                  for p in per_rank),
                "model_group_bytes_per_round_rank0": f0["model_bytes"],
                "wire_bits_per_param": f0["wire_bits"],
                "launches_per_round_rank0": {
                    k: n / TP_ROUNDS for k, n in f0["launches"].items()},
                "losses": [h["loss"] for h in f0["rounds"]],
                "vs_stacked": v,
                "plain_max_abs_err": max(
                    (rec["max_abs_err"] for p in per_rank
                     for rec in p["plain"].values()), default=0.0),
                "plain_shapes_rank0": {k: rec["shapes"]
                                       for k, rec in f0["plain"].items()},
                "card": smi}))
        print(f"tp round {where}: {len(res0['sharded'])} leaves sharded over "
              f"model={res0['shape'][1]}, D_local {res0['D_local']:,} of "
              f"{res0['D']:,}; layout {res0['layout']}")
    print(f"tp phase: {time.perf_counter() - t0:.1f} s  ({smi})")
    return total, err


LM_OVERRIDES = ("train.global_batch=12", "train.seq_len=512")
LM_D = 1_176_764_416
LM_MODES = ("paper", "int", "packed", "ring", "rsag", "auto")
LM_ROUNDS = 3
#: wire bits/param of each format at C = 2, 8 bits (the reference's plan;
#: "auto" picks the ring there)
LM_WIRE_BITS = {"paper": 32.0, "int": 16.0, "packed": 32.0 / 3, "ring": 8.0,
                "rsag": 28.0 / 3, "auto": 8.0}
#: the flat index the LM's (2, D) uplink passes: int32's limit
FLAT_LIMIT = 2 ** 31
#: words of each window the wire kernels are held in, and the small
#: reduced LM the card is held to the CPU on (the reference's trainer test)
LM_WINDOW = 4096
LM_SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
            "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512",
            "model.dtype=float32", "train.seq_len=32")


#: the zoo's models at full width: granite-moe-1b-a400m through the
#: cohort round at olmo-1b's cut, the trainer and the server (bfloat16, its
#: norm scales and router float32); qwen2.5-14b and yi-9b served (bfloat16,
#: float32 norm scales).  D from ``models.transformer.lm_param_shapes``.
GRANITE = "granite-moe-1b-a400m"
LM_DS = {"olmo-1b": LM_D, GRANITE: 1_384_963_072}
QWEN_D, YI_D = 14_770_033_664, 8_829_407_232
#: qwen2.5-14b's long-context cell: batch 1, a 16,384-token prompt into a
#: cache for 64 more (cut from prefill_32k's 32 x 32,768: the float32
#: chunked prefill's ~24,600 chunk pairs take ~20 s at this size)
QWEN_LONG = {"batch": 1, "prompt": 16_384, "max_len": 16_384 + 64}


#: the recurrent families at full width through the cohort round at
#: olmo-1b's cut, each cut in depth as far as the card's 80 GB force (two
#: stacked replicas, their (2, D) float32 uplink and rsag's buffers take
#: about 52 bytes a parameter): rwkv6-7b at 3 of 32 layers, and
#: recurrentgemma-2b, whose untied 256,000-token embedding and head are
#: 1.31e9 parameters alone, at 1 of 26 (a recurrent layer; at 2 layers,
#: D = 1,494,274,560, rsag's gather ran out of the card's memory).  D at
#: the cut from ``models.transformer.lm_param_shapes``
RWKV, GRIFFIN = "rwkv6-7b", "recurrentgemma-2b"
RECURRENT = (RWKV, GRIFFIN)
RECURRENT_LAYERS = {RWKV: 3, GRIFFIN: 1}
LM_DS.update({RWKV: 1_196_867_584, GRIFFIN: 1_402_498_560})
#: the full models served: D, and the state cache's bytes a sequence
RECURRENT_FULL_DS = {RWKV: 7_576_756_224, GRIFFIN: 3_549_934_080}
RECURRENT_CACHE_BYTES = {RWKV: 34_078_720, GRIFFIN: 17_246_208}
#: long_500k natively (``for_shape`` adds no window) at its batch of 1, the
#: prompt cut from 524,288 to what the per-token scan allows in the run's
#: time (recurrentgemma's a multiple of its 2,048 window)
RECURRENT_PROMPT = {RWKV: 4_096, GRIFFIN: 16_384}
#: rwkv6-7b's prefill at 2 layers, a prompt of 4,096 and one of 32,768:
#: their peaks above the parameters within PREFILL_FLAT_BYTES
RWKV_PREFILL_PROMPTS = (4_096, 32_768)
PREFILL_FLAT_BYTES = 64 << 20
#: the reduced float32 models held to the CPU, each where float32 agrees
#: (ROADMAP C7, ``tools/rwkv_conditioning.py``): the hybrid at 3 layers, so
#: that a local-attention layer is in it; rwkv served at 1 layer (a float32
#: ulp on every parameter moves its 2-layer outputs by 7e-5 of their
#: largest, its 1-layer ones and every other model's by under 2.2e-6: the
#: first layer's per-head group norm amplifies a near-zero variance, and a
#: second layer carries it into the state) and its round at lr 0.01 (at
#: 0.5 its first local step moves bonus_u by up to ~114 and the second
#: parts two float32 orders)
RECURRENT_SERVE_SMALL = {RWKV: ("model.n_layers=1",),
                         GRIFFIN: ("model.n_layers=3",)}
RECURRENT_ROUND_SMALL = {RWKV: ("fl.learning_rate=0.01",),
                         GRIFFIN: ("model.n_layers=3",)}


#: the rest of the zoo.  whisper-base (the encoder-decoder, D =
#: 97,182,720: bfloat16 weights, float32 layernorms) at full width and
#: depth through the cohort round at olmo-1b's C = 2 and I = 3, 12
#: sequences a round of 448 decoder tokens (its decoder's context) each
#: with its 1,500 frames of 512; served at the CLI's defaults and at
#: WHISPER_LONG (cut from decode_32k's batch of 128: its 32,768-slot self
#: cache and the 32,704-token prefill's activations at batch 128 are
#: ~110 GB).  deepseek-v3-671b (MLA, 1 shared + 256 routed experts top-8,
#: MTP) at full width and 1 of its 61 layers (D = 24,970,704,896 with the
#: MTP block, 49.95 GB: two layers would be 73 GB before activations);
#: chameleon-34b (vlm) at full width and depth (D = 34,293,424,128, 68.59
#: GB); both served at the CLI's defaults and at ZOO_LONG (QWEN_LONG's
#: cell).  D from ``models.build_model(cfg).num_params``
WHISPER, DEEPSEEK, CHAMELEON = ("whisper-base", "deepseek-v3-671b",
                                "chameleon-34b")
LM_DS[WHISPER] = 97_182_720
WHISPER_OVERRIDES = ("train.global_batch=12", "train.seq_len=448")
WHISPER_LONG = {"batch": 8, "prompt": 32_704, "max_len": 32_768}
DEEPSEEK_CUT = ("model.n_layers=1",)
ZOO_DS = {DEEPSEEK: 24_970_704_896, CHAMELEON: 34_293_424_128}
ZOO_LONG = QWEN_LONG
#: the reduced float32 rounds of the three against the CPU run every wire
#: format; their bfloat16 rounds (deepseek's and chameleon's) int and rsag
ZOO_SMALL_MODES = LM_MODES
#: reduced bfloat16 deepseek's first forward: the share of its second
#: layer's 512 expert picks that may differ between card and CPU (MLA's
#: bfloat16 products round otherwise on each side before that router; a
#: probe on the card saw 1 of 512, its first layer's picks equal)
DEEPSEEK_PICK_FLIPS = 0.01


def lm_config(get_config, apply_overrides, arch="olmo-1b"):
    cut = ((f"model.n_layers={RECURRENT_LAYERS[arch]}",)
           if arch in RECURRENT_LAYERS else ())
    run = WHISPER_OVERRIDES if arch == WHISPER else LM_OVERRIDES
    return apply_overrides(get_config(arch), run + cut)


def lm_batch(torch, token_batch, gen, cfg):
    """A round's batch: ``token_batch``'s tokens and labels, and for an
    encoder-decoder standard normal frames (B, encoder_seq_len, d_model)
    in float32 from the same generator."""
    m = cfg.model
    batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                        m.vocab_size)
    if m.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (cfg.train.global_batch, m.encoder_seq_len, m.d_model),
            generator=gen, device=gen.device)
    return batch


def float32_leaves(torch, model):
    """The float32 leaves, in leaf order: each steps in one ``fma_step``
    launch a local step (a bfloat16 LM's norm scales and biases and MoE
    router)."""
    layout = model.param_shapes
    return [k for k in layout if layout.dtypes[k] == torch.float32]


def lm_round_phase(torch, ops, get_config, apply_overrides, build_model,
                   token_batch, make_fl_round, tmesh, smi, arch="olmo-1b"):
    """The cohort round over ``arch`` at full width (olmo-1b: D =
    1,176,764,416 bfloat16 parameters, one flat vector; granite: D =
    1,384,963,072, a bfloat16 buffer and a float32 one; rwkv6-7b and
    recurrentgemma-2b at their RECURRENT_LAYERS cut; whisper-base whole,
    its batches carrying frames, ``lm_batch``), C = 2 cohorts
    (the (2, 4) mesh of 8 devices), I = 3, in each wire format of
    LM_MODES, LM_ROUNDS rounds each from the same parameters, batches and
    generator seed.  The launch counts are set to 0 just before each
    format's rounds and read just after, and checked against
    ``predicted_cohort_launches`` with no STE launch (the LM trains
    unquantized) and one ``fma_step`` a float32 leaf a local step;
    parameters ``torch.equal`` across int, packed, ring, rsag and auto
    after every round; loss finite; peak memory and round time per format,
    with each round's host time until ``make_fl_round``'s function returns
    (the round reads nothing back, so a host time near the round's time
    says the host, not the card, bounds it).  The rsag round's profile
    adds its host operators (LM_ROUNDS unprofiled rounds before it).
    Returns the launches summed over the formats."""
    from repro_torch import convert

    cfg = lm_config(get_config, apply_overrides, arch)
    model = build_model(cfg)
    layout = model.param_shapes
    sizes = tmesh.cohort_axis_sizes(tmesh.make_debug_mesh(8), cfg.fl.cohort_axes)
    C, I, R = math.prod(sizes), cfg.fl.local_iters, LM_ROUNDS
    n32 = len(float32_leaves(torch, model))
    check(model.num_params == LM_DS[arch] and (
        arch != "olmo-1b" or LM_D == cfg.model.param_count()),
        f"{arch} has {model.num_params:,} parameters, not {LM_DS[arch]:,}")
    check((C, I) == (2, 3) and not model.quantizes_training,
          f"LM round at C={C}, I={I}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params0 = model.init_flat(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [lm_batch(torch, token_batch, gen, cfg) for _ in range(R)]
    torch.cuda.synchronize()
    print(f"LM set-up: {time.perf_counter() - t0:.2f} s ({cfg.model.name}, "
          f"{layout}, {n32} float32 leaves, C = {C} cohorts at "
          f"{sizes}, I = {I}, {cfg.train.global_batch} x "
          f"{cfg.train.seq_len} tokens a round)")
    # warm-up (cuBLAS's first calls), outside the counted runs
    make_fl_round(model, cfg, sizes, collective="int")(
        params0, batches[0], torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()
    total = {k: 0 for k in ops.LAUNCHES}
    int_params = []
    for mode in LM_MODES:
        fn = make_fl_round(model, cfg, sizes, collective=mode)
        g = torch.Generator(device="cuda").manual_seed(11)
        params, hist, ms = params0, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        host_ms = []
        for r in range(R):
            t0 = time.perf_counter()
            params, m = fn(params, batches[r], g)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            loss = float(m["loss"])              # waits for the round
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            hist.append((loss, float(m["survivors"]), m["wire_bits_per_param"]))
            layout.check(params)
            if mode == "int":
                int_params.append([b.to("cpu") for b in
                                   convert.buffers(params)])
            elif mode != "paper":
                check(all(torch.equal(a, b.to("cuda")) for a, b in
                          zip(convert.buffers(params), int_params[r])),
                      f"LM round {r}: {mode} params differ from int")
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] += v
        want = {k: 0 for k in ops.LAUNCHES}
        want.update(predicted_cohort_launches(
            mode, cfg.quant.pipeline_hops, sizes,
            I if model.quantizes_training else 0, R, auto="ring"))
        want["fma_step"] += R * I * n32
        check(launches == want, f"LM {mode}: launches {launches} != "
                                f"predicted {want}")
        losses = [h[0] for h in hist]
        check(all(map(math.isfinite, losses)), f"LM {mode}: loss {losses}")
        check(all(bool(torch.isfinite(b).all())
                  for b in convert.buffers(params)),
              f"LM {mode}: non-finite params")
        check(abs(hist[0][2] - LM_WIRE_BITS[mode]) < 1e-9,
              f"LM {mode}: wire bits {hist[0][2]} != {LM_WIRE_BITS[mode]}")
        print(json.dumps({"lm_round": mode, "arch": cfg.model.name,
                          "n_layers": cfg.model.n_layers,
                          "D": model.num_params, "dtype": cfg.model.dtype,
                          "buffers": [[str(dt)[6:], n] for dt, n in zip(
                              layout.buffer_dtypes, layout.buffer_sizes)],
                          "axis_sizes": list(sizes), "C": C, "I": I,
                          "global_batch": cfg.train.global_batch,
                          "seq_len": cfg.train.seq_len, "losses": losses,
                          "survivors": [h[1] for h in hist],
                          "wire_bits_per_param": hist[0][2],
                          "round_ms": ms,
                          "round_ms_median": sorted(ms)[R // 2],
                          "round_host_ms": host_ms,
                          "max_memory_allocated_gb": peak / 1e9,
                          "launches": {k: v for k, v in launches.items() if v},
                          "card": smi}))
        del params, fn
    print(f"LM round ({cfg.model.name}): params torch.equal across int, "
          f"packed, ring, rsag and auto after each of {R} rounds at {sizes}; "
          f"launches as predicted, none of the STE, {R * I * n32} fma_step "
          f"a format ({n32} float32 leaves)")
    del int_params
    fn = make_fl_round(model, cfg, sizes, collective="rsag")
    g = torch.Generator(device="cuda").manual_seed(3)
    profile_phase(torch, f"make_fl_round rsag {cfg.model.name} {sizes}",
                  lambda: fn(params0, batches[0], g), rounds=LM_ROUNDS,
                  host_ops=12)
    return total


def planar_window(torch, W, cpw, n, w0, w1, device):
    """The flat indices j·W + w (j-major) of the codes that words [w0, w1)
    of a planar row of n codes hold: those below n.  Only the row's last
    words hold padding lanes, so a window that holds some ends at W, and
    the valid indices are a prefix: a plain version packs them into the
    same words."""
    w = torch.arange(w0, w1, dtype=torch.int64, device=device)
    idx = (torch.arange(cpw, dtype=torch.int64, device=device)[:, None] * W
           + w[None, :]).reshape(-1)
    valid = idx < n
    check(bool(valid.all()) or w1 == W, f"window [{w0}, {w1}) of {W} words "
                                        f"holds padding before its end")
    return idx[valid]


def lm_windows_phase(torch, ops, tref, quant, agg, D=LM_D):
    """The uplink's kernels at the LM round's shapes, (2, D) values past
    2^31 (olmo-1b: 2,353,528,832; granite: 2,769,926,144; each cohort's
    delta in leaf order), held ``torch.equal`` to their plain versions on
    windows: flat windows across index 2^31, across the row boundary and at
    the end; for the packed kernels, the words whose codes cross 2^31 in
    row 1 and each row's last words (the padded tail).  The plain versions
    compute in int64, so they run on the windows only.  Operands below
    2^31 values (whisper-base's 2 x 97,182,720) are held whole: every
    window is the whole row.  Launches here are not counted on any path.
    Returns the largest error per kernel."""
    torch.cuda.empty_cache()
    n2 = 2 * D
    G31 = FLAT_LIMIT
    whole = n2 < G31
    check(D % 2 == 0, f"the LM's uplink of D = {D} is odd")
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, D), generator=gen, device="cuda") * 0.02
    u = torch.rand((2, D), generator=gen, device="cuda")
    xf, uf = x.view(-1), u.view(-1)
    err, checked = {}, {}
    half = LM_WINDOW // 2

    def held(name, got, want, where):
        check(torch.equal(got, want),
              f"{name} at {where}: differs from its plain version")
        err[name] = max(err.get(name, 0.0), _max_diff(got, want))
        checked[name] = checked.get(name, 0) + 1

    flat_windows = (((0, n2),) if whole else
                    ((G31 - LM_WINDOW, G31 + LM_WINDOW),
                     (D - LM_WINDOW, D + LM_WINDOW), (n2 - LM_WINDOW, n2)))

    def word_windows(W, w=None):
        """Row 1's words around those holding flat index 2^31 (or ``w``),
        and the last words of a row; the whole row when held whole."""
        if whole:
            return ((0, W),)
        w = (G31 - D) % W if w is None else w
        return ((w - half, w + half), (W - LM_WINDOW, W))

    # int: the quantizer over (2, D), and its dequantize
    codes = ops.stochastic_quantize_codes(x, u, 8)
    deq = ops.dequantize_codes(codes, 8)
    for a, b in flat_windows:
        held("stochastic_quantize_codes", codes.view(-1)[a:b],
             tref.stochastic_quantize_ref(xf[a:b], uf[a:b], 8), (a, b))
        held("dequantize_codes", deq.view(-1)[a:b],
             tref.dequantize_ref(codes.view(-1)[a:b], 8), (a, b))
    del codes, deq

    # packed: quantize_pack at the guard lane, the word sum, unpack
    lane = quant.packed_lane_bits(8, 2)
    cpw = quant.codes_per_word(8, lane_bits=lane)
    words = ops.quantize_pack(x, u, 8, lane_bits=lane)
    W = words.shape[1]
    summed = agg.sum_words(words)
    vals = ops.unpack_dequantize(summed, 8, D, lane_bits=lane, sum_of=2)
    for w0, w1 in word_windows(W):
        idx = planar_window(torch, W, cpw, D, w0, w1, x.device)
        for r in (0, 1):
            held("quantize_pack", words[r, w0:w1],
                 tref.quantize_pack_ref(x[r, idx][None], u[r, idx][None], 8,
                                        lane_bits=lane)[0], (r, w0, w1))
        held("unpack_dequantize", vals[idx],
             tref.unpack_dequantize_ref(summed[w0:w1], 8, idx.numel(),
                                        lane_bits=lane, sum_of=2), (w0, w1))
    del words, summed, vals

    # ring: the pipelined front-end (one chunk) and the hop into its codes
    words, codes = ops.quantize_pack_chunk(x, u, 8, lane_bits=8, num_chunks=1)
    buf, acc = words.reshape(2, -1), codes.reshape(2, D)
    W, cpw = buf.shape[1], quant.codes_per_word(8, lane_bits=8)
    for a, b in flat_windows:
        held("quantize_pack_chunk", codes.view(-1)[a:b],
             tref.stochastic_quantize_ref(xf[a:b], uf[a:b], 8), (a, b))
    windows = [(w0, w1, planar_window(torch, W, cpw, D, w0, w1, x.device))
               for w0, w1 in word_windows(W)]
    before = [acc[1, idx].clone() for _, _, idx in windows]
    for w0, w1, idx in windows:
        held("quantize_pack_chunk", buf[1, w0:w1],
             tref.quantize_pack_chunk_ref(x[1, idx][None], u[1, idx][None], 8,
                                          lane_bits=8)[0].reshape(-1),
             (1, w0, w1))
    ops.repack(buf, acc, 8, D, hop=1, lane_bits=8, axis_size=2, inner=1)
    for (w0, w1, idx), acc0 in zip(windows, before):
        held("repack", acc[1, idx],
             tref.repack_ref(buf[0:1, w0:w1], acc0[None].clone(), 8,
                             idx.numel(), lane_bits=8)[0], (1, w0, w1))
    del words, codes, buf, acc

    # rsag: two chunks a row at lane 8, the scatter hop's pack_sums of
    # partial sums of 2 codes at lane 9, and the gather's unpack
    b8 = quant.lane_bias(8)
    words, codes = ops.quantize_pack_chunk(x, u, 8, lane_bits=8,
                                           num_chunks=2, bias=b8)
    Cc, Wc = codes.shape[2], words.shape[2]
    for a, b in flat_windows:
        held("quantize_pack_chunk", codes.view(-1)[a:b],
             tref.stochastic_quantize_ref(xf[a:b], uf[a:b], 8), (a, b))
    for c in (0, 1):
        for w0, w1 in word_windows(Wc, (G31 - D - c * Cc) % Wc):
            idx = planar_window(torch, Wc, cpw, Cc, w0, w1, x.device)
            held("quantize_pack_chunk", words[1, c, w0:w1],
                 tref.quantize_pack_chunk_ref(
                     x[1, c * Cc + idx][None], u[1, c * Cc + idx][None], 8,
                     lane_bits=8, bias=b8)[0].reshape(-1), (1, c, w0, w1))
    lane9, b9 = quant.packed_lane_bits(8, 2), quant.lane_bias(
        quant.packed_lane_bits(8, 2))
    cpw9 = quant.codes_per_word(8, lane_bits=lane9)
    sums = (codes[:, 0] + codes[:, 1]).contiguous()
    packed = ops.pack_sums(sums, 8, lane_bits=lane9, bias=b9)
    vals = ops.unpack_dequantize(packed, 8, Cc, lane_bits=lane9, bias=b9)
    W9 = packed.shape[1]
    for w0, w1 in word_windows(W9, W9 // 2):
        idx = planar_window(torch, W9, cpw9, Cc, w0, w1, x.device)
        held("pack_sums", packed[1, w0:w1],
             tref.pack_sums_ref(sums[1, idx][None], 8, lane_bits=lane9,
                                bias=b9)[0], (1, w0, w1))
        held("unpack_dequantize", vals[1, idx],
             tref.unpack_dequantize_ref(packed[1, w0:w1], 8, idx.numel(),
                                        lane_bits=lane9, bias=b9), (1, w0, w1))
    print(json.dumps({"lm_uplink_windows": {
        "shape": [2, D], "values": n2, "past_2_31": n2 - G31, "whole": whole,
        "window_words": LM_WINDOW, "windows_checked": checked,
        "max_abs_err": err}}))
    return err


def lm_reference_phase(torch, get_config, apply_overrides, build_model,
                       make_fl_round, RoundNoise, arch="olmo-1b",
                       dtype="float32", extra=(), modes=("int", "rsag"),
                       pick_flips=0.0):
    """A reduced LM round on the card against the same round on the CPU
    (the reference trainer test's size, C = 4, I = 2, lr 0.5, q = 0.3), in
    ``modes`` (int and rsag; every format for the last three of the zoo,
    ZOO_SMALL_MODES, whisper's batch carrying normal frames).  olmo-1b is LM_SMALL, the others ``reduced``.  In
    float32 (one buffer; granite's MoE: routing, dispatch, combine, aux)
    within the CPU tests' float32 bound: every parameter within one uplink
    code step, 99.9 % within 1e-5, loss rtol 1e-4.  qwen2.5-14b in
    bfloat16, its norm scales float32 (the mixed layout: ``_delta`` and
    ``_apply`` run by run, float32 leaves stepped as strided views), within
    the bound tests/test_torch_leaf_dtypes.py holds that round to: at
    least 97 % of the parameters equal, every one within two code steps
    and a bfloat16 ulp, loss rtol 1e-3.  granite in bfloat16 (the mixed
    layout and the MoE): the first forward's expert picks and keep mask
    equal and the loss within rtol 1e-3; its parameters' agreement is
    printed, not bounded: a bfloat16 ulp in the first step's weights
    flips a few picks of the second (4-5 of 512 on the card), and a
    flipped pick moves its tokens' rows by several code steps.
    recurrentgemma-2b and rwkv6-7b in float32 (``extra``,
    RECURRENT_ROUND_SMALL: the hybrid at 3 layers, rwkv at lr 0.01) within
    the float32 bound.  deepseek-v3-671b in bfloat16 as granite, but
    where MLA's bfloat16 products precede the second layer's router, a
    share ``pick_flips`` of that layer's picks may differ in the first
    forward (its first layer's picks and keep mask equal)."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.models import mlp as tmlp

    C, I, B = 4, 2, 16
    run = (f"fl.local_iters={I}", "fl.learning_rate=0.5",
           f"train.global_batch={B}", "channel.error_prob=0.3")
    if arch == "olmo-1b":
        cfg = apply_overrides(get_config(arch), LM_SMALL + run)
    else:
        cfg = apply_overrides(reduced(get_config(arch)), run + (
            "train.seq_len=32", f"model.dtype={dtype}") + tuple(extra))
    model = build_model(cfg)
    mixed = dtype != "float32"
    moe = cfg.model.moe.enabled
    check(len(model.param_shapes.buffer_dtypes) == (2 if mixed else 1)
          and cfg.model.dtype == dtype,
          f"LM reference {arch}: {model.param_shapes}")
    gen = torch.Generator().manual_seed(7)
    params = model.init_flat(3, device="cpu")
    tok = torch.randint(0, cfg.model.vocab_size, (B, 32), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    if cfg.model.is_encoder_decoder:
        batch["frames"] = torch.randn(
            (B, cfg.model.encoder_seq_len, cfg.model.d_model), generator=gen)
    noise = RoundNoise(None, torch.rand((C, model.num_params), generator=gen),
                       torch.tensor([1.0, 0.0, 1.0, 1.0]))

    def values(flat):
        return torch.cat([b.float().cpu() for b in convert.buffers(flat)])

    route, picks = tmlp.route, []

    def recorded(logits, cfg, capacity):
        out = route(logits, cfg, capacity)
        picks.append((out[1].argmax(-1).cpu(), out[4].cpu()))
        return out

    for mode in modes:
        out, first = {}, {}
        for dev in ("cpu", "cuda"):
            fn = make_fl_round(model, cfg, (C,), collective=mode, device=dev)
            picks.clear()
            tmlp.route = recorded
            try:
                new, m = fn(convert.map_buffers(lambda b: b.to(dev), params),
                            {k: v.to(dev) for k, v in batch.items()},
                            noise=RoundNoise(None, noise.u_up.to(dev),
                                             noise.lam.to(dev)))
            finally:
                tmlp.route = route
            check([b.dtype for b in convert.buffers(new)]
                  == list(model.param_shapes.buffer_dtypes),
                  f"LM reference {arch} {mode}: buffers of new parameters")
            out[dev] = (values(new), float(m["loss"]))
            first[dev] = list(picks)
        want = out["cpu"][0]
        diff = (out["cuda"][0] - want).abs()
        moved = float((want - values(params)).abs().max())
        equal = float((diff == 0).float().mean())
        within = float((diff <= 1e-5).float().mean())
        steps = float(diff.max()) * 128
        flips = [int((a[0] != b[0]).sum()) for a, b in zip(first["cuda"],
                                                            first["cpu"])]
        print(f"card vs CPU, one reduced {dtype} {arch} "
              f"({cfg.model.n_layers} layers) round ({C},) I={I} "
              f"lr {cfg.fl.learning_rate:g} ({mode}): max param diff {float(diff.max()):.3g} ({steps:.3g} "
              f"code steps; moved up to {moved:.3g}), {equal:.6f} equal, "
              f"{within:.6f} within 1e-5, loss {out['cuda'][1]:.6f} vs "
              f"{out['cpu'][1]:.6f}" + (
                  f", picks that differ in each of the round's routings (the "
                  f"first {cfg.model.n_layers} its first forward's): "
                  f"{flips} of {first['cpu'][0][0].numel()}" if moe else ""))
        check(all(torch.isfinite(out[d][0]).all() for d in out),
              f"LM {arch} {mode}: non-finite parameters")
        if moe:
            L = cfg.model.n_layers
            exact = L if pick_flips == 0 else 1
            check(len(first["cuda"]) == len(first["cpu"]) >= L and all(
                torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                for a, b in zip(first["cuda"][:exact], first["cpu"][:exact]))
                and all(f <= pick_flips * first["cpu"][0][0].numel()
                        for f in flips[exact:L]),
                f"LM {arch} {mode}: the first forward's expert picks or "
                "keep mask differ from the CPU's")
        bad = f"LM {arch} {mode}: round parameters disagree with the CPU path"
        if not mixed:
            check(steps <= 1 + 128e-7 and within >= 0.999, bad)
        elif not moe:
            check(bool((diff <= 2 / 128 + want.abs() * 2.0 ** -7).all())
                  and equal >= 0.97, bad)
        rtol = 1e-3 if mixed else 1e-4
        check(abs(out["cuda"][1] - out["cpu"][1]) <= rtol * abs(out["cpu"][1]),
              f"LM {arch} {mode}: loss disagrees with the CPU path")


def mixed_layout_phase(torch, get_config, apply_overrides, build_model):
    """The mixed layout's elementwise pieces of the round on the card
    against the CPU, ``torch.equal``, on reduced bfloat16 granite (a
    bfloat16 and a float32 buffer, C = 4): ``fl.sgd_step_`` on a loss whose
    gradient is a given g (bfloat16 leaves a product and a difference,
    float32 leaves ``fma_step_`` on their strided views), ``fl._delta``
    into the (C, D) float32 wire vector in leaf order and ``fl._apply``."""
    from repro_torch import convert
    from repro_torch.configs import reduced
    from repro_torch.core import fl as tfl

    C = 4
    model = build_model(reduced(get_config(GRANITE)))
    layout = model.param_shapes
    check(layout.buffer_dtypes == (torch.bfloat16, torch.float32),
          f"mixed layout: {layout}")
    gen = torch.Generator().manual_seed(1)
    w = model.init_flat(3, device="cpu")
    g = convert.map_buffers(lambda b: (torch.randn(
        b.shape, generator=gen) * 0.1).to(b.dtype), w)
    p = convert.map_buffers(lambda b: (b.float() + torch.randn(
        b.shape, generator=gen) * 1e-2).to(b.dtype).expand(C, -1).clone(), w)
    d = torch.randn(layout.numel, generator=gen) * 1e-3
    res = {}
    for dev in ("cpu", "cuda"):
        def on(flat):
            return convert.map_buffers(lambda b: b.to(dev).clone(), flat)
        stepped, grads = on(w), convert.unflatten_params(on(g), layout)
        tfl.sgd_step_(lambda lv: (sum((lv[k].float() * grads[k].float()).sum()
                                      for k in lv), None), stepped, layout, 0.5)
        res[dev] = [convert.buffers(stepped),
                    (tfl._delta(on(p), on(w), layout),),
                    convert.buffers(tfl._apply(on(w), d.to(dev), layout))]
    same = {name: all(torch.equal(a.cpu(), b) for a, b in zip(x, y))
            for name, x, y in zip(("step", "delta", "apply"), res["cuda"],
                                  res["cpu"])}
    print(f"card vs CPU, the mixed layout's step, delta and apply on reduced "
          f"bfloat16 {GRANITE} ({layout}): torch.equal {same}")
    check(all(same.values()), f"mixed layout: the card differs {same}")


def recurrent_phases(torch, ops, tref, quant, agg, err, get_config,
                     apply_overrides, build_model, token_batch, make_fl_round,
                     tmesh, train_main, RoundNoise, smi, arch):
    """A recurrent family on the card: serving at full width
    (``recurrent_serve_phase``); the cohort round at RECURRENT_LAYERS in
    every format (``lm_round_phase``); the uplink kernels on its (2, D) windows (their errors
    into ``err``); the trainer, 2 rsag steps; a reduced float32 round on
    the card against the CPU in int and rsag.  Returns the launches of its
    round and trainer paths."""
    recurrent_serve_phase(torch, get_config, apply_overrides, build_model,
                          smi, arch)
    launches = lm_round_phase(torch, ops, get_config, apply_overrides,
                              build_model, token_batch, make_fl_round, tmesh,
                              smi, arch=arch)
    for k, v in lm_windows_phase(torch, ops, tref, quant, agg,
                                 D=LM_DS[arch]).items():
        err[k] = max(err[k], v)
    n32 = len(float32_leaves(torch, build_model(
        lm_config(get_config, apply_overrides, arch))))
    for k, v in lm_train_phase(torch, ops, train_main, smi, arch,
                               n32).items():
        launches[k] += v
    lm_reference_phase(torch, get_config, apply_overrides, build_model,
                       make_fl_round, RoundNoise, arch, "float32",
                       extra=RECURRENT_ROUND_SMALL[arch])
    return launches


def zoo_layout_line(torch, model, arch, **extra):
    """One JSON line: the model's D, its buffers and float32 leaves."""
    layout = model.param_shapes
    print(json.dumps({"zoo_layout": arch, "D": model.num_params,
                      "buffers": [[str(dt)[6:], n] for dt, n in zip(
                          layout.buffer_dtypes, layout.buffer_sizes)],
                      "float32_leaves": len(float32_leaves(torch, model)),
                      "param_bytes": sum(dt.itemsize * n for dt, n in zip(
                          layout.buffer_dtypes, layout.buffer_sizes)),
                      **extra}))


def whisper_phases(torch, ops, tref, quant, agg, err, get_config,
                   apply_overrides, build_model, token_batch, make_fl_round,
                   tmesh, train_main, RoundNoise, smi):
    """whisper-base (the encoder-decoder) at full width and depth: served
    through ``launch.serve.main`` at the CLI's defaults (1,500 frames of
    512 drawn from the port's generator) and at WHISPER_LONG (8 x 32,704
    into a 32,768 self cache, 64 decode steps, ``serve_cell``); a reduced
    float32 whisper served on the card against the CPU; the cohort round
    at C = 2, I = 3, 12 x 448 tokens with their frames, in every format
    (``lm_round_phase``: parameters ``torch.equal`` across the quantized
    formats); the uplink kernels held to their plain versions on its
    whole (2, D) operands; ``fma_step`` on its float32 leaves held to
    ``fma32``; the trainer's refusal; a reduced float32 round on the card
    against the CPU in every format.  Returns the round's launches."""
    from repro_torch.configs import reduced
    from repro_torch.configs.shapes import SHAPES

    cfg = get_config(WHISPER)
    model = build_model(cfg)
    check(model.num_params == LM_DS[WHISPER] and cfg.model.is_encoder_decoder
          and model.param_shapes.buffer_dtypes == (torch.bfloat16,
                                                   torch.float32),
          f"{WHISPER}: {model.param_shapes}")
    zoo_layout_line(torch, model, WHISPER,
                    encoder_seq_len=cfg.model.encoder_seq_len)
    serve_cli_phase(torch, WHISPER, smi)
    torch.cuda.empty_cache()
    params = model.init(0)
    w = WHISPER_LONG
    serve_cell(torch, model, params, cfg, w["batch"], w["prompt"],
               w["max_len"], "(whisper b) 32k context",
               dataclasses.replace(SHAPES["prefill_32k"],
                                   global_batch=w["batch"],
                                   seq_len=w["prompt"]),
               dataclasses.replace(SHAPES["decode_32k"],
                                   global_batch=w["batch"],
                                   seq_len=w["max_len"]), smi, profile=True)
    del params
    torch.cuda.empty_cache()
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(cfg), ("model.dtype=float32",)), 32, 40, "max_len 40")
    launches = lm_round_phase(torch, ops, get_config, apply_overrides,
                              build_model, token_batch, make_fl_round, tmesh,
                              smi, arch=WHISPER)
    for k, v in lm_windows_phase(torch, ops, tref, quant, agg,
                                 D=LM_DS[WHISPER]).items():
        err[k] = max(err[k], v)
    err["fma_step"] = max(err["fma_step"], float32_fma_phase(
        torch, ops, tref, build_model, get_config, WHISPER))
    try:
        train_main(["--arch", WHISPER, "--devices", "8", "--steps", "1"])
    except NotImplementedError as e:
        check("frames" in str(e), f"{WHISPER} trainer refused: {e}")
        print(f"{WHISPER} trainer refuses, as the reference's cannot train "
              f"it: {e}")
    else:
        check(False, f"the trainer ran {WHISPER} on batches without frames")
    lm_reference_phase(torch, get_config, apply_overrides, build_model,
                       make_fl_round, RoundNoise, WHISPER, "float32",
                       modes=ZOO_SMALL_MODES)
    return launches


def zoo_long_serve(torch, model, cfg, label, smi):
    """``serve_cell`` at ZOO_LONG (1 x 16,384 into a 16,448 cache, 64
    steps), the parameters drawn on the card and freed after."""
    from repro_torch.configs.shapes import SHAPES

    torch.cuda.empty_cache()
    params = model.init(0)
    z = ZOO_LONG
    serve_cell(torch, model, params, cfg, z["batch"], z["prompt"],
               z["max_len"], label,
               dataclasses.replace(SHAPES["prefill_32k"],
                                   global_batch=z["batch"], seq_len=z["prompt"]),
               dataclasses.replace(SHAPES["decode_32k"],
                                   global_batch=z["batch"],
                                   seq_len=z["max_len"]), smi, profile=True)
    del params
    torch.cuda.empty_cache()


def deepseek_serve_phase(torch, get_config, apply_overrides, build_model,
                         smi):
    """deepseek-v3-671b at full width and 1 of 61 layers (DEEPSEEK_CUT:
    MLA, 1 shared + 256 routed experts top-8, the MTP block's leaves too;
    D = 24,970,704,896): ``launch.serve.main`` at the CLI's defaults, then
    ZOO_LONG; the latent cache's bytes a token a layer against a full K
    and V's (128 heads of 192 and 128); a reduced float32 deepseek served
    on the card against the CPU."""
    from repro_torch.configs import reduced
    from repro_torch.models import mla

    cfg = apply_overrides(get_config(DEEPSEEK), DEEPSEEK_CUT)
    model = build_model(cfg)
    m = cfg.model
    check(model.num_params == ZOO_DS[DEEPSEEK] and m.mla.enabled
          and m.mtp_depth == 1 and m.moe.num_shared_experts == 1,
          f"{DEEPSEEK}: {model.param_shapes}")
    itemsize = torch.empty((), dtype=model.dtype).element_size()
    latent = mla.latent_width(m) * itemsize
    full_kv = m.n_heads * (m.mla.qk_nope_head_dim + m.mla.qk_rope_head_dim
                           + m.mla.v_head_dim) * itemsize
    meta = model.init_cache(1, 1024, device="meta")
    check(meta["latent"].nbytes == 1024 * latent * m.n_layers,
          f"{DEEPSEEK}: latent cache {tuple(meta['latent'].shape)}")
    zoo_layout_line(torch, model, DEEPSEEK, n_layers=m.n_layers,
                    cache_bytes_per_token_per_layer=latent,
                    full_kv_bytes_per_token_per_layer=full_kv,
                    kv_over_latent=full_kv / latent)
    serve_cli_phase(torch, DEEPSEEK, smi, DEEPSEEK_CUT)
    zoo_long_serve(torch, model, cfg, "(deepseek b) long context, 1 layer",
                   smi)
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(get_config(DEEPSEEK)), ("model.dtype=float32",)), 32, 40,
        "max_len 40")


def chameleon_serve_phase(torch, get_config, apply_overrides, build_model,
                          smi):
    """chameleon-34b (vlm: a dense stack over VQ token ids) at full width
    and depth (D = 34,293,424,128, 68.59 GB): ``launch.serve.main`` at the
    CLI's defaults, then ZOO_LONG; a reduced float32 chameleon served on
    the card against the CPU."""
    from repro_torch.configs import reduced

    cfg = get_config(CHAMELEON)
    model = build_model(cfg)
    check(model.num_params == ZOO_DS[CHAMELEON] and cfg.model.family == "vlm"
          and cfg.model.frontend == "vq_tokens",
          f"{CHAMELEON}: {model.param_shapes}")
    zoo_layout_line(torch, model, CHAMELEON, n_layers=cfg.model.n_layers)
    torch.cuda.empty_cache()
    serve_cli_phase(torch, CHAMELEON, smi)
    zoo_long_serve(torch, model, cfg, "(chameleon b) long context", smi)
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(cfg), ("model.dtype=float32",)), 32, 40, "max_len 40")


def zoo_reference_rounds(torch, get_config, apply_overrides, build_model,
                         make_fl_round, RoundNoise):
    """deepseek-v3-671b's and chameleon-34b's reduced rounds on the card
    against the CPU: float32 in every format, bfloat16 in int and rsag."""
    for arch in (DEEPSEEK, CHAMELEON):
        lm_reference_phase(torch, get_config, apply_overrides, build_model,
                           make_fl_round, RoundNoise, arch, "float32",
                           modes=ZOO_SMALL_MODES)
        lm_reference_phase(torch, get_config, apply_overrides, build_model,
                           make_fl_round, RoundNoise, arch, "bfloat16",
                           pick_flips=DEEPSEEK_PICK_FLIPS)


def lm_train_phase(torch, ops, train_main, smi, arch="olmo-1b", n32=0):
    """The reference's trainer entry point on the card:
    ``repro_torch.launch.train.main`` for 2 steps of ``arch`` at full width
    (a recurrent arch at its RECURRENT_LAYERS cut) on the 8-device mesh in
    rsag, the counts set to 0 just before and read just after, with one
    ``fma_step`` a float32 leaf (``n32`` of them) a local step.  Returns
    the launches."""
    cut = ((f"model.n_layers={RECURRENT_LAYERS[arch]}",)
           if arch in RECURRENT_LAYERS else ())
    argv = ["--arch", arch, "--devices", "8", "--collective", "rsag",
            "--steps", "2", "--log-every", "1", *LM_OVERRIDES, *cut]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train_main(argv)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(predicted_cohort_launches("rsag", True, (2,), 0, 2))
    want["fma_step"] += 2 * 3 * n32         # 2 steps, I = 3 local steps each
    check(launches == want, f"trainer: launches {launches} != predicted {want}")
    check(out["kind"] == "fl_round" and out["cohorts"] == 2
          and out["steps"] == 2, f"trainer ran {out}")
    check(math.isfinite(out["loss"]) and out["params_finite"],
          f"trainer: loss {out['loss']}")
    print(json.dumps({"lm_trainer": " ".join(argv), **{
        k: out.get(k) for k in ("kind", "mesh", "cohorts", "steps", "loss",
                            "tok_s", "seconds", "max_memory_allocated")},
        "launches": {k: v for k, v in launches.items() if v}, "card": smi}))
    return launches


def fleet_reference_phase(torch, get_config, build_model, FLSimulator,
                          convert, tfleet, smi):
    """Small fleet rounds on the card against the same rounds on the CPU,
    on one set of draws.  One ``FLSimulator`` fleet round (K=3, I=2, B=8,
    4,096 devices, rate_aware selection at the configured power): the
    selected ids and their validity equal, uplink codes and parameters
    as ``reference_phase`` holds them.  Then ``round_update``, 3 rounds
    from one fleet for each selection × power policy at 0 dBm noise: idx,
    valid and λ equal, except that where the card's float32 arithmetic
    reorders scores the CPU rounds equal within 2 ulps, both picks must
    score within 2 ulps on the CPU (ROADMAP C3); such swaps are
    counted."""
    from repro_torch.config.base import POWER_POLICIES, SELECTION_POLICIES

    K, I, B, n = 3, 2, 8, 4096
    cfg = fleet_config(paper_config(get_config, K=K, I=I, batch=B), n,
                       "rate_aware", "fixed", error_prob=0.3)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(8)
    params = convert.flatten_params(model.init(3, device="cpu"))
    D = params.numel()
    batches = {"images": torch.randn((K, I, B, 28, 28, 1), generator=gen),
               "labels": torch.randint(0, 10, (K, I, B), generator=gen)}
    fleet = tfleet.init_fleet(1, cfg, device="cpu")
    draws = tfleet.draw_round(gen, cfg, n, K)
    noise = {"u_train": torch.rand((K, I, D), generator=gen),
             "u_up": torch.rand((K, D), generator=gen)}
    alphas = torch.tensor([0.1, 0.25, 0.05])

    def on(dev, x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(dev)
        return type(x)(*(on(dev, t) for t in x))

    out = {}
    for dev in ("cpu", "cuda"):
        sim = FLSimulator(model, cfg, WeightStore(torch, dev), device=dev)
        new, _, tel = sim._fleet_round(
            params.to(dev), on(dev, fleet), {k: v.to(dev) for k, v in batches.items()},
            alphas.to(dev), draws=on(dev, draws),
            **{k: v.to(dev) for k, v in noise.items()})
        out[dev] = (new.cpu(), {k: v.cpu() for k, v in tel.items()})
    for k in ("selected", "valid", "survivors"):
        check(torch.equal(out["cuda"][1][k], out["cpu"][1][k]),
              f"fleet round on the card: {k} {out['cuda'][1][k]} != CPU "
              f"{out['cpu'][1][k]}")
    perr = (out["cuda"][0] - out["cpu"][0]).abs()
    check(float(perr.max()) <= 1 / 128 and float((perr <= 1e-5).float().mean()) >= 0.999,
          "fleet round parameters disagree with the CPU path")
    print(f"card vs CPU, one FLSimulator fleet round K={K} I={I} B={B} over "
          f"{n} devices: selected {out['cpu'][1]['selected'].tolist()} and "
          f"valid equal, max param diff {float(perr.max()):.3g}")

    swaps, rounds = 0, 0
    for selection in SELECTION_POLICIES:
        for policy in POWER_POLICIES:
            c = fleet_config(cfg, n, selection, policy, noise_psd_dbm=0.0)
            c = dataclasses.replace(c, fleet=dataclasses.replace(
                c.fleet, harvest_j_per_round=0.05))
            states = {d: on(d, tfleet.init_fleet(2, c, device="cpu"))
                      for d in ("cpu", "cuda")}
            g = torch.Generator().manual_seed(9)
            for r in range(3):
                dr = tfleet.draw_round(g, c, n, 16)
                seen = {}
                for d in ("cpu", "cuda"):
                    states[d], info = tfleet.round_update(
                        states[d], None, c, D, 16, draws=on(d, dr))
                    seen[d] = {k: getattr(info, k).cpu()
                               for k in ("idx", "valid", "lam", "scores")}
                what = f"round_update {selection}/{policy} round {r}"
                check(torch.equal(seen["cuda"]["valid"], seen["cpu"]["valid"]),
                      f"{what}: valid differs")
                rounds += 1
                if torch.equal(seen["cuda"]["idx"], seen["cpu"]["idx"]):
                    check(torch.equal(seen["cuda"]["lam"], seen["cpu"]["lam"]),
                          f"{what}: lam differs")
                    continue
                scores = seen["cpu"]["scores"]
                a = scores[seen["cpu"]["idx"]]
                b = scores[seen["cuda"]["idx"]]
                tol = 2 * torch.finfo(torch.float32).eps * a.abs()
                check(bool(((a == b) | ((a - b).abs() <= tol)).all()),
                      f"{what}: idx {seen['cuda']['idx'].tolist()} != CPU "
                      f"{seen['cpu']['idx'].tolist()} beyond a float32 tie")
                swaps += 1
    print(f"card vs CPU, round_update over every selection × power policy "
          f"(3 rounds each, {n} devices): valid equal in all {rounds}; idx "
          f"and lam equal in {rounds - swaps}, the rest reordered only among "
          f"scores within 2 float32 ulps")
    return swaps


def planner_phase(torch, get_config, optimize, smi):
    """The paper's §III two-stage planner on the card (``joint_optimize``,
    60 CMA-ES iterations, the objective on the card) against the paper's
    trends, as tests/test_fl_system.py:125 holds the reference: q* <= 0.05,
    P_tx* in the box, τ within tau_limit_s, FP8 >= 70 % below FP32."""
    from repro_torch.configs.mnist_cnn import PAPER_MACS, PAPER_WEIGHTS

    cfg = get_config("mnist_cnn")
    t0 = time.perf_counter()
    res = optimize.joint_optimize(cfg, num_params=PAPER_WEIGHTS,
                                  macs_per_iter=PAPER_MACS, max_iters=60,
                                  seed=0)
    host_s = time.perf_counter() - t0
    saving = 1 - res.per_bits[8]["energy_j"] / res.per_bits[32]["energy_j"]
    print(json.dumps({"joint_optimize": {
        "p_tx": res.p_tx, "q": res.q, "bits": res.bits,
        "energy_j": res.energy_j, "tau_pr_s": res.tau_pr_s,
        "rounds_T": res.rounds_T, "fp8_saving_vs_fp32": saving,
        "cmaes_iterations": res.cmaes_result.iterations,
        "per_bits": {str(k): v for k, v in res.per_bits.items()},
        "host_s": host_s, "card": smi}}))
    check(res.q <= 0.05, f"joint_optimize: q* {res.q} should approach 0.01")
    check(0.1 <= res.p_tx <= 2.0, f"joint_optimize: P_tx* {res.p_tx}")
    check(res.tau_pr_s <= cfg.fl.tau_limit_s, f"joint_optimize: τ {res.tau_pr_s}")
    check(saving >= 0.70, f"joint_optimize: FP8 saves {saving:.2%} < 70%")


def power_policy_phase(torch, get_config, tfleet, tpower, energy_mod, smi):
    """The four power policies over POWER_CHECK["rounds"] rounds of the
    population layer alone (``round_update``, no training) at
    POWER_CHECK["size"] devices, cohort 64, uniform selection, 0 dBm noise
    (where the inversion policies bite), ``fixed`` and the shared (P_tx, q)
    from ``calibrate_fixed_power`` (CMA-ES on the card), as the
    reference's ``benchmarks/power_policies.py`` runs them: the mean
    uplink energy of the cohort and its realized outage a round, read
    once after the last round.  channel_inversion and fbl_target must
    spend no more uplink energy than fixed at an outage at most
    outage_tol above it (that script's gate)."""
    pc = POWER_CHECK
    D, R, k = 421_642, pc["rounds"], pc["cohort"]
    cfg = get_config("mnist_cnn")
    cfg = fleet_config(dataclasses.replace(
        cfg, fl=dataclasses.replace(cfg.fl, devices_per_round=k)),
        pc["size"], "uniform", "fixed", noise_psd_dbm=pc["noise_psd_dbm"])
    t0 = time.perf_counter()
    cal = tpower.calibrate_fixed_power(
        cfg, num_params=D, macs_per_iter=cfg.energy.macs_per_iteration,
        max_iters=pc["cmaes_iters"])
    cal_s = time.perf_counter() - t0
    stats = {}
    for policy in ("fixed", "channel_inversion", "fbl_target", "lyapunov"):
        c = dataclasses.replace(cal, power=dataclasses.replace(cal.power,
                                                               policy=policy))
        state = tfleet.init_fleet(0, c)
        gen = torch.Generator(device="cuda").manual_seed(1)
        acc = torch.zeros(3, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(R):
            state, info = tfleet.round_update(state, gen, c, D, k)
            e_u = energy_mod.capped_uplink_energy_j(
                c.channel, D, tpower.uplink_bits(c), info.rates_sel,
                c.fl.tau_limit_s, tx_power_w=info.power_sel)
            n_valid = torch.clamp(info.valid.sum(), min=1.0)
            acc += torch.stack([(info.valid * e_u).sum(),
                                info.outage_sel.sum() / n_valid,
                                info.lam.sum()]).double()
        up, outage, surv = (acc / R).tolist()
        ms = (time.perf_counter() - t0) * 1e3
        stats[policy] = {"uplink_energy_j_mean": up, "outage_rate_mean": outage,
                         "survivors_round_mean": surv,
                         "alive_at_end": int((state.battery_j > 0).sum()),
                         "power_mean_w": float(state.p_last.mean()),
                         "rounds_host_ms": ms}
    print(json.dumps({"power_policies": {
        "fleet_size": pc["size"], "rounds": R, "cohort": k,
        "noise_psd_dbm": pc["noise_psd_dbm"], "p_fixed_cmaes_w": cal.power.p_fixed,
        "error_prob_cmaes": cal.channel.error_prob, "calibrate_s": cal_s,
        "policies": stats, "card": smi}}))
    fixed = stats["fixed"]
    for policy in ("channel_inversion", "fbl_target"):
        got = stats[policy]
        check(got["uplink_energy_j_mean"] <= fixed["uplink_energy_j_mean"] * (1 + 1e-6)
              and got["outage_rate_mean"] <= fixed["outage_rate_mean"] + pc["outage_tol"],
              f"power policy {policy}: uplink {got['uplink_energy_j_mean']} J "
              f"outage {got['outage_rate_mean']} against fixed "
              f"{fixed['uplink_energy_j_mean']} J {fixed['outage_rate_mean']}")
    return stats


def profile_phase(torch, label, run_round, rounds=5, host_ops=0):
    """Device busy share of a round.  The round time is the median host time
    of ``rounds`` unprofiled rounds, each ended by ``synchronize``; the
    device time by kernel comes from one more round under a CUDA-only
    ``torch.profiler`` trace (CUPTI), which adds no per-op host tracing but
    can slow the kernels themselves: the busy share is given both against
    the unprofiled median and against the traced round's own time.  With
    ``host_ops`` > 0, one more round traced with CPU activity too gives the
    ``host_ops`` operators with the most host (self CPU) time, and the
    kernel launches the round enqueued, by API call (cuBLAS launches its
    own kernels through the driver's ``cuLaunchKernelEx``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    round_ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_round()
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_round()
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
        "path": label,
        "round_ms_unprofiled": round_ms, "round_ms_median": median_ms,
        "round_ms_profiled": profiled_ms,
        "device_busy_ms": busy_ms if rows else None,
        "device_busy_share": busy_ms / median_ms if rows else None,
        "device_busy_share_of_profiled_round":
            busy_ms / profiled_ms if rows else None,
        "top_kernels": [{"name": k[:80], "ms": ms, "calls": n}
                        for ms, n, k in rows[:12]]}}))
    if host_ops:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_round()
            torch.cuda.synchronize()
        evts = list(prof.key_averages())
        evts.sort(key=lambda e: -e.self_cpu_time_total)
        launches = {e.key: e.count for e in evts if e.key in (
            "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")}
        print(json.dumps({"profile_host": {
            "path": label,
            "kernel_launches": sum(launches.values()),
            "kernel_launches_by_call": launches,
            "top_host_ops": [{"op": e.key[:70],
                              "self_cpu_ms": e.self_cpu_time_total / 1e3,
                              "calls": e.count} for e in evts[:host_ops]]}}))


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


def time_queued_ms(torch, fn, reps=50):
    """As ``time_ms``, but each launch waits behind a device sleep after the
    flush, so that its span starts only once the host has queued ``fn``: a
    slow host does not add its enqueue time to a short kernel.  The sleep
    is lengthened, up to 10^8 cycles, while a start event had run before
    its launch was queued.  Returns the median and the count of such late
    launches at the last length; a median with late launches may still
    hold host time."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    for _ in range(5):
        fn()
    cycles = 10 ** 6
    while True:
        pairs, late = [], 0
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(cycles)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            late += int(s.query())
            pairs.append((s, e))
        torch.cuda.synchronize()
        if not late or cycles >= 10 ** 8:
            break
        cycles *= 4
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2], late


def queued_quartiles_ms(torch, fns, reps=100):
    """Quartiles [q1, median, q3] of each of ``fns``'s times as
    ``time_queued_ms`` takes them (L2 flushed, the launch queued behind a
    device sleep), the calls interleaved, in turns forward then backward,
    so that a drift of the card's clock falls on all alike.  Returns
    {name: quartiles} and the count of launches whose start event had run
    before they were queued."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    for fn in fns.values():
        for _ in range(5):
            fn()
    pairs = {k: [] for k in fns}
    late = 0
    for i in range(reps):
        for k in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            flush.zero_()
            torch.cuda._sleep(4 * 10 ** 6)
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fns[k]()
            e.record()
            late += int(s.query())
            pairs[k].append((s, e))
    torch.cuda.synchronize()
    out = {}
    for k, ps in pairs.items():
        t = sorted(s.elapsed_time(e) for s, e in ps)
        out[k] = [t[len(t) // 4], t[len(t) // 2], t[3 * len(t) // 4]]
    return out, late


def host_ms(torch, fn, reps=50):
    """Median host time of one call of ``fn`` through the return of
    ``torch.cuda.synchronize()``, L2 warm: what a caller that waits for the
    result sees, the entry point's Python and its launch included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def time_back_to_back_ms(torch, fn, reps=50):
    """Mean device time of ``reps`` launches of ``fn`` run back to back
    between two events, L2 not flushed between them.  For a kernel shorter
    than the host's enqueue time, one event pair around one launch measures
    the enqueue.  Here the card is first put to sleep (``torch.cuda._sleep``)
    so that the events and all ``reps`` launches are queued before it
    wakes; if the start event has already run when the last launch is
    queued, the card caught up with the host and the sleep is lengthened."""
    for _ in range(5):
        fn()
    cycles = 10 ** 7
    while cycles <= 10 ** 10:
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        queued = not s.query()
        torch.cuda.synchronize()
        if queued:
            return s.elapsed_time(e) / reps
        cycles *= 4
    raise AssertionError("the card never got ahead of the host's enqueue")


def bound_ms(nbytes: float, nops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def copy_yardstick(torch, nbytes):
    """``dst.copy_(src)`` of int32 tensors of nbytes / 8 elements each: a
    pass that reads and writes about ``nbytes`` without computing anything
    (another function than the kernel's, and another split of reads and
    writes).  Returns (label, call, bytes moved)."""
    src = torch.zeros(int(nbytes) // 8, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    return (f"dst.copy_(src), int32 of {src.numel():,} elements",
            lambda: dst.copy_(src), 8.0 * src.numel())


def launch_blocks(ops, kind, tensor, lane, rows, W):
    """(blocks a launch of ``kind`` makes, as its plan reports them, and
    the blocks of the earlier design, one block per 256 words a row) for
    8-bit codes at ``lane``; a checkout without the plan reports the
    latter twice."""
    old = rows * -(-W // 256)
    plan_of = getattr(ops, f"{kind}_plan", None)
    return (plan_of(tensor, 8, lane_bits=lane).blocks if plan_of else old), old


def launch_floor_phase(torch, ops, grids, smi):
    """``ops.null_kernel``, an empty kernel launched through the wire
    kernels' ctypes path, at each grid of ``grids`` blocks of 256 threads,
    in the timing phase's four columns.  No kernel of the port: the kernels
    line does not list it.  Returns {blocks: times}, empty for a checkout
    without the kernel."""
    null = getattr(ops, "null_kernel", None)
    floor = {}
    if null is None:
        print("launch_floor: not reported (no null kernel in this checkout)")
        return floor
    dev = torch.device("cuda")
    for blocks in grids:
        fn = lambda b=blocks: null(b, dev)
        queued, late = time_queued_ms(torch, fn)
        floor[blocks] = {"ms": time_ms(torch, fn), "ms_queued": queued,
                         "ms_queued_late": late,
                         "ms_back_to_back": time_back_to_back_ms(torch, fn),
                         "host_ms": host_ms(torch, fn)}
        print(json.dumps({"timing": "launch_floor", "blocks": blocks,
                          "threads": 256, **floor[blocks],
                          "is": "an empty kernel through the wire kernels' "
                                "ctypes path, not a kernel of the port",
                          "card": smi}))
    return floor


def timing_phase(torch, ops, tref, quant, agg, smi, sub_alpha_once):
    """Every kernel at the shape the main paths give it (8 bits, C=K=10,
    D=421,642): the packed psum's lane 12 for quantize_pack and
    unpack_dequantize, the ring's native lane 8 for quantize_pack_chunk
    (k=1) and one repack hop, the two-axis ring's level change for
    pack_sums (lane 9, sums of 2), qmatmul at the QNN's fc1 over 960
    images.  Extra rows time pack_sums at an rsag hop (C=10 chunks of
    42,165, lane 12), unpack_dequantize at rsag's last store (the same
    chunks' words into f32) and qmatmul at (256, 512, 256).  Bounds count each
    input byte read once and each output byte written once; integer
    operations of the wire kernels are counted against the f32 rate, as
    the bytes bound every one of them, and qmatmul's against the int8
    tensor-core rate.  Every kernel is also timed queued behind a device
    sleep (``ms_queued``, with the count of launches still late) and back to
    back (``ms_back_to_back``, the pattern of the ring's hops); where the
    bound is under SHORT_BOUND_MS the plain version is timed back to back
    too.  Every entry point is timed on the host
    through a synchronize (``host_ms``); where there is a library call it
    is also queued, run back to back and timed on the host.
    ``torch._int_mm`` is timed with w in both layouts; each ``library_*``
    number is the faster.  The row ``fake_quant_pair`` is the quantizer's
    two kernels as a round runs them, quantize then dequantize of its
    codes, and ``chunk_repack_pair`` the ring's front and first hop,
    quantize_pack_chunk then one repack of its words into its codes in
    place (no kernel of their own: the kernels line does not list them);
    their bounds keep the handed-over outputs in L2 and
    ``bound_ms_codes_through_hbm`` does not.  Quantize, quantize_pack and
    quantize_pack_chunk are also timed beside ``torch.add(x, u)``, which
    moves quantize's 12 bytes an element without computing anything
    (``traffic_yardstick_*``, not a library call), and pack_sums and
    unpack_dequantize beside a ``copy_`` of about their bytes, and so is
    masked_aggregate, whose row carries its launch plan; the row
    ``uplink_aggregate_pair`` is the round's kernels from the uplink's
    codes to eq. 6: dequantize_codes, then ``error_aware_aggregate``'s
    weights ``alphas * lambdas`` and masked_aggregate of the f32 (its
    bound keeps the f32 in L2, ``bound_ms_f32_through_hbm`` does not).  The rows
    ``rsag_hop_pair`` (pack_sums at the hop shape, then one repack hop of
    its words) and ``rsag_tail_pair`` (the last pack_sums, then
    unpack_dequantize into f32) are rsag's chains.  An empty kernel
    (``launch_floor``) is timed at 1 block and at every grid these
    launches make, now and in the earlier design of one block per 256
    words (columns, for masked_aggregate), and each of their rows carries
    the floor at its own grid.  The row ``fma_step`` is the QNN's float32
    local step over (K, D) in place; ``w.sub_(g, alpha=eta)`` is its
    library call where it rounds once on the card (``sgd_phase``), else its
    same-bytes yardstick; the row also gives both one's queued quartiles,
    interleaved (``queued_quartiles_ms``)."""
    K, D = SHAPES["main"]
    n = K * D
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.rand((K, D), generator=gen, device="cuda") - 0.5) * 0.02
    u = torch.rand((K, D), generator=gen, device="cuda")
    codes = ops.stochastic_quantize_codes(x, u, 8)
    w = torch.rand(K, generator=gen, device="cuda") * 0.1
    den = torch.clamp(w.sum(), min=1e-12)                  # a divisor on the card
    lam = (torch.arange(K, device="cuda") != 3).float()    # one packet lost
    inv_gain = 1.0 / 128
    lane = quant.packed_lane_bits(8, K)                     # 12: 2 codes a word
    W = quant.packed_words(D, 8, lane_bits=lane)
    summed = agg.sum_words(ops.quantize_pack(x, u, 8, lane_bits=lane))  # (W,)
    Wn = quant.packed_words(D, 8)                            # 4 codes a word
    ring_words = ops.quantize_pack(x, u, 8)                  # (K, Wn)
    acc = codes.clone()
    sums2 = torch.randint(-256, 255, (K, D), generator=gen, device="cuda",
                          dtype=torch.int32)
    W9 = quant.packed_words(D, 8, lane_bits=9)
    chunk = -(-D // K)
    hop_sums = torch.randint(-1280, 1271, (K, chunk), generator=gen,
                             device="cuda", dtype=torch.int32)
    W12c = quant.packed_words(chunk, 8, lane_bits=12)
    bias12 = quant.lane_bias(12)
    hop_words = ops.pack_sums(hop_sums, 8, lane_bits=12, bias=bias12)
    hop_acc = hop_sums.clone()
    mm = {}
    for M, Kd, N in QMATMUL_SHAPES[:2]:
        mm[M, Kd, N] = (
            torch.randint(-128, 128, (M, Kd), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.randint(-128, 128, (Kd, N), generator=gen, device="cuda",
                          dtype=torch.int8))
    (xq, wq), (xs, ws) = mm[960, 3136, 128], mm[256, 512, 256]
    # the QNN's float32 local step over (K, D), in place
    eta = float(torch.tensor(0.05, dtype=torch.float32))
    neg_eta = torch.tensor(-eta, device="cuda")
    sw = torch.randn((K, D), generator=gen, device="cuda") * 0.05
    sg = torch.randn((K, D), generator=gen, device="cuda")
    # column-major copies of w, the layout cuBLASLt's int8 kernels favour
    wq_cm, ws_cm = wq.t().contiguous().t(), ws.t().contiguous().t()

    def chunk_then_hop(m):
        """quantize_pack_chunk (k = 1) then one repack hop of its words
        into its codes, through ``ops`` or the plain versions ``tref``."""
        if m is ops:
            words, codes = ops.quantize_pack_chunk(x, u, 8, num_chunks=1)
            return ops.repack(words.view(K, Wn), codes.view(K, D), 8, D, hop=1)
        words, codes = tref.quantize_pack_chunk_ref(x, u, 8, num_chunks=1)
        return tref.repack_ref(words.view(K, Wn), codes.view(K, D), 8, D, hop=1)

    def sums_then(m, second):
        """rsag's pack_sums at the hop shape, then ``second`` of its words:
        one repack hop into an accumulator in place ("repack"), or the
        last store into f32 ("unpack"), through ``ops`` or the plain
        versions ``tref``."""
        kw = dict(lane_bits=12, bias=bias12)
        if m is ops:
            words = ops.pack_sums(hop_sums, 8, **kw)
            if second == "repack":
                return ops.repack(words, hop_acc, 8, chunk, hop=1, **kw)
            return ops.unpack_dequantize(words, 8, chunk, **kw)
        words = tref.pack_sums_ref(hop_sums, 8, **kw)
        if second == "repack":
            return tref.repack_ref(words, hop_acc, 8, chunk, hop=1, **kw)
        return tref.unpack_dequantize_ref(words, 8, chunk, **kw)

    rows = {
        "stochastic_quantize_codes": (
            lambda: ops.stochastic_quantize_codes(x, u, 8),
            lambda: tref.stochastic_quantize_ref(x, u, 8), None,
            12.0 * n, 8.0 * n),
        "dequantize_codes": (
            lambda: ops.dequantize_codes(codes, 8),
            lambda: tref.dequantize_ref(codes, 8),
            {"": lambda: torch.mul(codes, inv_gain)}, 8.0 * n, 1.0 * n),
        # what FakeQuantSTE.forward and the uplink run; the bound keeps the
        # codes in L2 between the two launches
        "fake_quant_pair": (
            lambda: ops.dequantize_codes(ops.stochastic_quantize_codes(x, u, 8), 8),
            lambda: tref.dequantize_ref(tref.stochastic_quantize_ref(x, u, 8), 8),
            None, 12.0 * n, 9.0 * n),
        "masked_aggregate": (
            lambda: ops.masked_aggregate(x, w),
            lambda: tref.masked_aggregate_ref(x, w),
            {"": lambda: (w @ x) / torch.clamp(w.sum(), min=1e-12)},
            4.0 * n + 4.0 * D + 4.0 * K, 2.0 * n),
        # the same with the divisor given on the card (the fleet's IPW
        # aggregate): one more float32 read
        "masked_aggregate_den": (
            lambda: ops.masked_aggregate(x, w, den=den),
            lambda: tref.masked_aggregate_ref(x, w, den=den),
            {"": lambda: (w @ x) / den},
            4.0 * n + 4.0 * D + 4.0 * K + 4.0, 2.0 * n),
        # the round's kernels from the uplink's codes to eq. 6: dequantize,
        # then error_aware_aggregate's weights alphas * lambdas and
        # masked_aggregate; the bound keeps the f32 in L2
        "uplink_aggregate_pair": (
            lambda: ops.masked_aggregate(ops.dequantize_codes(codes, 8),
                                         (w * lam).float().contiguous()),
            lambda: tref.masked_aggregate_ref(tref.dequantize_ref(codes, 8),
                                              (w * lam).float().contiguous()),
            None, 4.0 * n + 4.0 * D + 16.0 * K, 3.0 * n + K),
        "quantize_pack": (
            lambda: ops.quantize_pack(x, u, 8, lane_bits=lane),
            lambda: tref.quantize_pack_ref(x, u, 8, lane_bits=lane), None,
            8.0 * n + 4.0 * K * W, 8.0 * n),
        "unpack_dequantize": (
            lambda: ops.unpack_dequantize(summed, 8, D, lane_bits=lane, sum_of=K),
            lambda: tref.unpack_dequantize_ref(summed, 8, D, lane_bits=lane,
                                               sum_of=K), None,
            4.0 * W + 4.0 * D, 4.0 * D),
        "quantize_pack_chunk": (
            lambda: ops.quantize_pack_chunk(x, u, 8, num_chunks=1),
            lambda: tref.quantize_pack_chunk_ref(x, u, 8, num_chunks=1), None,
            8.0 * n + 4.0 * K * Wn + 4.0 * n, 8.0 * n),
        # the ring's front and its first hop: the hop reads the words and
        # updates the codes in place; the bound keeps both in L2
        "chunk_repack_pair": (
            lambda: chunk_then_hop(ops),
            lambda: chunk_then_hop(tref), None,
            8.0 * n + 4.0 * K * Wn + 4.0 * n, 9.0 * n),
        "repack": (
            lambda: ops.repack(ring_words, acc, 8, D, hop=1),
            lambda: tref.repack_ref(ring_words, acc, 8, D, hop=1), None,
            4.0 * K * Wn + 8.0 * n, 4.0 * n),
        "pack_sums": (
            lambda: ops.pack_sums(sums2, 8, lane_bits=9, sum_of=2),
            lambda: tref.pack_sums_ref(sums2, 8, lane_bits=9, sum_of=2), None,
            4.0 * n + 4.0 * K * W9, 2.0 * n),
        "pack_sums@rsag_hop": (
            lambda: ops.pack_sums(hop_sums, 8, lane_bits=12, bias=bias12),
            lambda: tref.pack_sums_ref(hop_sums, 8, lane_bits=12, bias=bias12),
            None, 4.0 * K * chunk + 4.0 * K * W12c, 2.0 * K * chunk),
        # rsag's last store at (10,): the final pack_sums' words into f32
        "unpack_dequantize@rsag": (
            lambda: ops.unpack_dequantize(hop_words, 8, chunk, lane_bits=12,
                                          bias=bias12),
            lambda: tref.unpack_dequantize_ref(hop_words, 8, chunk,
                                               lane_bits=12, bias=bias12),
            None, 4.0 * K * W12c + 4.0 * K * chunk, 4.0 * K * chunk),
        # an rsag hop and rsag's tail; the bounds keep the words in L2
        "rsag_hop_pair": (
            lambda: sums_then(ops, "repack"), lambda: sums_then(tref, "repack"),
            None, 12.0 * K * chunk + 4.0 * K * W12c, 6.0 * K * chunk),
        "rsag_tail_pair": (
            lambda: sums_then(ops, "unpack"), lambda: sums_then(tref, "unpack"),
            None, 8.0 * K * chunk + 4.0 * K * W12c, 6.0 * K * chunk),
        "qmatmul": (
            lambda: ops.qmatmul(xq, wq, 0.05, 0.1),
            lambda: tref.qmatmul_ref(xq, wq, 0.05, 0.1),
            {"w_row_major": lambda: torch._int_mm(xq, wq),
             "w_col_major": lambda: torch._int_mm(xq, wq_cm)},
            960 * 3136 + 3136 * 128 + 4.0 * 960 * 128,
            2.0 * 960 * 3136 * 128, INT8_OPS_PER_S),
        "qmatmul@256x512x256": (
            lambda: ops.qmatmul(xs, ws, 0.05, 0.1),
            lambda: tref.qmatmul_ref(xs, ws, 0.05, 0.1),
            {"w_row_major": lambda: torch._int_mm(xs, ws),
             "w_col_major": lambda: torch._int_mm(xs, ws_cm)},
            256 * 512 + 512 * 256 + 4.0 * 256 * 256,
            2.0 * 256 * 512 * 256, INT8_OPS_PER_S),
        # w read and written, g read; sub_ with alpha is the same function
        # only where it rounds once (sgd_phase)
        "fma_step": (
            lambda: ops.fma_step_(sw, sg, eta),
            lambda: tref.fma32(neg_eta, sg, sw),
            {"": lambda: sw.sub_(sg, alpha=eta)} if sub_alpha_once else None,
            12.0 * n, 2.0 * n),
    }
    # about the bytes the kernel moves, not its function: no library_ms
    yardsticks = {k: ("torch.add(x, u)", lambda: torch.add(x, u), 12.0 * n)
                  for k in ("stochastic_quantize_codes", "quantize_pack",
                            "quantize_pack_chunk")}
    for k in ("unpack_dequantize", "pack_sums", "pack_sums@rsag_hop",
              "unpack_dequantize@rsag", "masked_aggregate",
              "masked_aggregate_den"):
        yardsticks[k] = copy_yardstick(torch, rows[k][3])
    if not sub_alpha_once:
        yardsticks["fma_step"] = ("w.sub_(g, alpha=eta), two roundings",
                                  lambda: sw.sub_(sg, alpha=eta), 12.0 * n)
    shapes = {"pack_sums@rsag_hop": [K, chunk], "qmatmul": [960, 3136, 128],
              "qmatmul@256x512x256": [256, 512, 256],
              "unpack_dequantize@rsag": [K, chunk], "rsag_hop_pair": [K, chunk],
              "rsag_tail_pair": [K, chunk]}
    # blocks each launch of pack_sums and unpack_dequantize makes, now and
    # at one block per 256 words a row; a pair adds its second launch
    grids = {"unpack_dequantize": launch_blocks(ops, "unpack_dequantize",
                                                summed, 12, 1, W),
             "pack_sums": launch_blocks(ops, "pack_sums", sums2, 9, K, W9),
             "pack_sums@rsag_hop": launch_blocks(ops, "pack_sums", hop_sums,
                                                 12, K, W12c),
             "unpack_dequantize@rsag": launch_blocks(
                 ops, "unpack_dequantize", hop_words, 12, K, W12c),
             # the plan's blocks, and the earlier one block per 256 columns
             "masked_aggregate": (ops.masked_aggregate_plan(x).blocks,
                                  -(-D // 256))}
    grids["masked_aggregate_den"] = grids["masked_aggregate"]
    pair_grids = {"rsag_hop_pair": (grids["pack_sums@rsag_hop"][0],
                                    K * -(-W12c // 256)),          # repack's
                  "rsag_tail_pair": (grids["pack_sums@rsag_hop"][0],
                                     grids["unpack_dequantize@rsag"][0])}
    floor = launch_floor_phase(torch, ops, sorted(
        {1} | {b for g in grids.values() for b in g}
        | {b for g in pair_grids.values() for b in g}), smi)
    out = {}
    for name, (kernel, plain, library, nbytes, nops, *rate) in rows.items():
        b_ms, b_by = bound_ms(nbytes, nops, *rate)
        layouts = library or {}     # the library call, by layout of its operands
        lib_ms = {k: time_ms(torch, f) for k, f in layouts.items()}
        out[name] = {"ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
                     "library_ms": min(lib_ms.values()) if lib_ms else None,
                     "bound_ms": b_ms, "bound_by": b_by}
        queued, late = time_queued_ms(torch, kernel)
        extra = {"ms_queued": queued, "ms_queued_late": late,
                 "ms_back_to_back": time_back_to_back_ms(torch, kernel),
                 "host_ms": host_ms(torch, kernel)}
        if name == "fake_quant_pair":
            extra["bound_ms_codes_through_hbm"] = 20.0 * n / HBM_BYTES_PER_S * 1e3
        if name == "fma_step":
            extra["sub_alpha_rounds_once"] = sub_alpha_once
            quart, late_q = queued_quartiles_ms(
                torch, {"kernel": kernel, "sub_": lambda: sw.sub_(sg, alpha=eta)})
            extra.update(ms_queued_quartiles_interleaved=quart,
                         ms_queued_quartiles_late=late_q)
        if name == "chunk_repack_pair":
            extra["bound_ms_codes_through_hbm"] = (
                20.0 * n + 8.0 * K * Wn) / HBM_BYTES_PER_S * 1e3
        if name == "uplink_aggregate_pair":
            extra["bound_ms_f32_through_hbm"] = (
                12.0 * n + 4.0 * D + 16.0 * K) / HBM_BYTES_PER_S * 1e3
        if name in ("masked_aggregate", "masked_aggregate_den"):
            extra["plan"] = ops.masked_aggregate_plan(x)._asdict()
        launched = (grids[name][:1] if name in grids
                    else pair_grids.get(name, ()))
        if launched:
            extra["blocks"] = list(launched)
        if launched and floor:
            extra.update({f"launch_floor_{k}": sum(floor[b][k] for b in launched)
                          for k in ("ms_queued", "ms_back_to_back")})
        if name in yardsticks:
            what, fn, y_bytes = yardsticks[name]
            y_queued, y_late = time_queued_ms(torch, fn)
            extra.update(bytes=nbytes, traffic_yardstick=what,
                         traffic_yardstick_bytes=y_bytes,
                         traffic_yardstick_ms=time_ms(torch, fn),
                         traffic_yardstick_ms_queued=y_queued,
                         traffic_yardstick_ms_queued_late=y_late,
                         traffic_yardstick_ms_back_to_back=
                         time_back_to_back_ms(torch, fn))
        if layouts:
            lib_queued = {k: time_queued_ms(torch, f) for k, f in layouts.items()}
            lib_host = {k: host_ms(torch, f) for k, f in layouts.items()}
            b2b = {k: time_back_to_back_ms(torch, f) for k, f in layouts.items()}
            best = min(lib_queued, key=lambda k: lib_queued[k][0])
            extra.update(library_ms_queued=lib_queued[best][0],
                         library_ms_queued_late=lib_queued[best][1],
                         library_ms_back_to_back=min(b2b.values()),
                         library_host_ms=min(lib_host.values()))
            if len(layouts) > 1:
                extra.update(library_ms_by_layout=lib_ms,
                             library_ms_queued_by_layout={
                                 k: v[0] for k, v in lib_queued.items()},
                             library_ms_back_to_back_by_layout=b2b,
                             library_host_ms_by_layout=lib_host)
        if b_ms < SHORT_BOUND_MS and not name.endswith("_pair"):
            extra["plain_ms_back_to_back"] = time_back_to_back_ms(torch, plain)
        print(json.dumps({"timing": name, "shape": shapes.get(name, [K, D]),
                          **out[name], **extra,
                          "ms_is": "median of 50 single launches, L2 flushed "
                                   "before each by writing 256 MB",
                          "ms_queued_is": "the same, each launch queued behind "
                                          "a device sleep after the flush",
                          "ms_back_to_back_is": "mean of 50 launches queued "
                                                "behind a sleep and run back to "
                                                "back between two events, L2 warm",
                          "host_ms_is": "median host time of one call through "
                                        "a synchronize, L2 warm",
                          "library": LIBRARY_CALLS.get(name.split("@")[0]),
                          "card": smi}))
        out[name].update(extra)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; it needs a card")
    started = time.perf_counter()
    from repro_torch import convert
    from repro_torch.config import apply_overrides
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import aggregation as agg
    from repro_torch.core import quantization as quant
    from repro_torch.core import energy as energy_mod
    from repro_torch.core import optimize
    from repro_torch.core.fl import FLSimulator, RoundNoise, local_sgd, make_fl_round
    from repro_torch.data.pipeline import make_federated_digits
    from repro_torch.data.synthetic import digit_dataset, token_batch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as tref
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.train import main as train_main
    from repro_torch import obs
    from repro_torch.models import build_model
    from repro_torch.population import fleet as tfleet
    from repro_torch.population import power as tpower
    from repro_torch.population import telemetry

    name, count, smi = device_phase(torch)
    build_phase(build)
    err = kernels_phase(torch, ops, tref)
    for k, v in zip(("masked_aggregate", "masked_aggregate_den"),
                    aggregate_paths_phase(torch, ops, tref)):
        err[k] = max(err[k], v)
    for k, v in quantizer_paths_phase(torch, ops, tref).items():
        err[k] = max(err[k], v)
    err.update(wire_kernels_phase(torch, ops, tref, quant))
    for k, v in wire_quantizer_paths_phase(torch, ops, tref).items():
        err[k] = max(err[k], v)
    err["qmatmul"], qmatmul_launches = qmatmul_phase(torch, ops, tref)
    err["fma_step"], sub_alpha_once = sgd_phase(torch, ops, tref)
    launches, sim, params = main_path_phase(torch, ops, get_config, build_model,
                                            make_federated_digits, FLSimulator,
                                            convert)
    sim_gen = torch.Generator(device="cuda").manual_seed(3)
    profile_phase(torch, "FLSimulator", lambda: sim.run_round(params, sim_gen))
    reference_phase(torch, get_config, build_model, FLSimulator, convert)
    fleet_sim = fleet_simulator_phase(torch, ops, sim, get_config, FLSimulator,
                                      convert, smi)
    fleet_reference_phase(torch, get_config, build_model, FLSimulator, convert,
                          tfleet, smi)
    telemetry_phase(torch, sim, get_config, FLSimulator, convert, obs,
                    telemetry, smi)
    cohort = cohort_round_phase(torch, ops, get_config, build_model,
                                digit_dataset, make_fl_round, smi)
    for sizes, collective in (((4,), "packed"), ((2, 2), "rsag")):
        cohort_reference_phase(torch, get_config, build_model, make_fl_round,
                               local_sgd, RoundNoise, quant, sizes, collective)
    fleet_cohort = cohort_fleet_phase(torch, ops, get_config, build_model,
                                      digit_dataset, make_fl_round, tfleet, smi)
    dist, dist_err = dist_phase(torch, run_ranks, smi)
    for k, v in dist_err.items():
        err[k] = max(err[k], v)
    tp, tp_err = tp_phase(torch, run_ranks, smi)
    for k, v in tp_err.items():
        err[k] = max(err[k], v)
    lm = lm_round_phase(torch, ops, get_config, apply_overrides, build_model,
                        token_batch, make_fl_round, tmesh, smi)
    for k, v in lm_windows_phase(torch, ops, tref, quant, agg).items():
        err[k] = max(err[k], v)
    lm_reference_phase(torch, get_config, apply_overrides, build_model,
                       make_fl_round, RoundNoise)
    for k, v in lm_train_phase(torch, ops, train_main, smi).items():
        lm[k] += v
    granite = lm_round_phase(torch, ops, get_config, apply_overrides,
                             build_model, token_batch, make_fl_round, tmesh,
                             smi, arch=GRANITE)
    for k, v in lm_windows_phase(torch, ops, tref, quant, agg,
                                 D=LM_DS[GRANITE]).items():
        err[k] = max(err[k], v)
    err["fma_step"] = max(err["fma_step"], float32_fma_phase(
        torch, ops, tref, build_model, get_config))
    for k, v in granite_train_phase(torch, ops, train_main, get_config,
                                    apply_overrides, build_model, smi).items():
        granite[k] += v
    for arch, dtype in ((GRANITE, "float32"), ("qwen2.5-14b", "bfloat16"),
                        (GRANITE, "bfloat16")):
        lm_reference_phase(torch, get_config, apply_overrides, build_model,
                           make_fl_round, RoundNoise, arch, dtype)
    mixed_layout_phase(torch, get_config, apply_overrides, build_model)
    serve_cli_phase(torch, GRANITE, smi)
    serve_reference_check(torch, build_model, apply_overrides(
        reduced(get_config(GRANITE)), ("model.dtype=float32",)), 32, 40,
        "max_len 40")
    checkpoint_phase(torch, train_main, get_config, apply_overrides,
                     build_model, smi)
    planner_phase(torch, get_config, optimize, smi)
    power_policy_phase(torch, get_config, tfleet, tpower, energy_mod, smi)
    round_update_phase(torch, get_config, tfleet, smi)
    serve_phase(torch, get_config, apply_overrides, build_model, smi)
    zoo_serve_phase(torch, get_config, apply_overrides, build_model, smi)
    rec = {arch: recurrent_phases(torch, ops, tref, quant, agg, err,
                                  get_config, apply_overrides, build_model,
                                  token_batch, make_fl_round, tmesh,
                                  train_main, RoundNoise, smi, arch)
           for arch in RECURRENT}
    whisper = whisper_phases(torch, ops, tref, quant, agg, err, get_config,
                             apply_overrides, build_model, token_batch,
                             make_fl_round, tmesh, train_main, RoundNoise, smi)
    deepseek_serve_phase(torch, get_config, apply_overrides, build_model, smi)
    chameleon_serve_phase(torch, get_config, apply_overrides, build_model,
                          smi)
    zoo_reference_rounds(torch, get_config, apply_overrides, build_model,
                         make_fl_round, RoundNoise)
    times = timing_phase(torch, ops, tref, quant, agg, smi, sub_alpha_once)
    # qmatmul is on no round: its entry point is the kernel API, driven by
    # qmatmul_phase with the counts reset just before
    path_launches = {k: launches[k] + cohort[k] + fleet_sim[k] + fleet_cohort[k]
                     + lm[k] + granite[k] + sum(r[k] for r in rec.values())
                     + whisper[k] + dist.get(k, 0) + tp.get(k, 0)
                     for k in KERNELS}
    path_launches["qmatmul"] = qmatmul_launches
    for k, n in path_launches.items():
        check(n > 0, f"{k} was not launched on its path")
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": path_launches[k], "max_abs_err": err[k],
                **times[k], "launches_lm": lm[k],
                "launches_granite": granite[k],
                **{f"launches_{arch}": rec[arch][k] for arch in RECURRENT},
                "launches_whisper": whisper[k],
                "launches_dist": dist.get(k, 0),
                "launches_tp": tp.get(k, 0),
                **({"replaces_note": note[0]} if note else {})}
               for k, (src, rep, *note) in KERNELS.items()]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
