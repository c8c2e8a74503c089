"""How the L2 flush before a timed launch moves a one-pass kernel's time,
and whether the quantizers' L2 cache hints pay.

``chip_smoke.py`` times a single launch after writing 256 MB, which leaves
L2 full of dirty lines that are written back while the kernel runs.  This
probe times each case as the median of 50 single launches between two
CUDA events after each of two flushes, writing 256 MB (chip_smoke's
``ms``) and reading them (L2 left clean), and as the mean of 50 launches
back to back (chip_smoke's ``ms_back_to_back``).  The cases, at the main
paths' shapes:

* one ``repack`` ring hop (10 rows of 105,411 words into 10 x 421,642
  int32, lane 8) and a ``copy_`` of the same 33.7 MB of acc;
* the quantizer at (10, 421,642), 8 bits: ``stochastic_quantize_codes``,
  ``dequantize_codes``, the two as a round runs them (quantize, then
  dequantize of its codes), and ``torch.add(x, u)``, which moves
  quantize's 12 bytes an element.  The three quantizer cases run twice
  through the kernels' C entry points: built as the port builds them
  (with their L2 cache hints) and built with -DREPRO_PLAIN_CACHE_POLICY
  (plain loads and stores).
* ``quantize_pack_chunk`` at the ring's front (10 x 421,642, lane 8, one
  chunk) and the pair the ring runs, the chunk then one ``repack`` hop
  of its words into its codes in place, through ``pack.cu``'s C entry
  points built as the port builds it (x and u loaded streaming, codes
  stored ``evict_last``) and with -DREPRO_PLAIN_CACHE_POLICY.
* rsag's kernels at (10,), 8 bits, lane 12: ``pack_sums`` at a hop (10
  rows of 42,165 partial sums), the hop's chain (``pack_sums``, then one
  ``repack`` hop of its words) and the tail's (``pack_sums``, then
  ``unpack_dequantize`` into f32), and ``unpack_dequantize`` at rsag's
  last store and at the packed psum's (one row of 210,821 summed words),
  and ``pack_sums`` at the two-axis ring's level change (10 x 421,642
  sums of 2, lane 9), through ``pack.cu``'s C entry points built as the
  port builds it (the f32 stored ``evict_last``) and with
  -DREPRO_PLAIN_CACHE_POLICY (stored plainly).
* ``masked_aggregate`` at (10, 421,642) f32 and the round's kernels
  from the uplink's codes to eq. 6 (``dequantize_codes``, then
  ``error_aware_aggregate``'s weights ``alphas * lambdas`` and
  ``masked_aggregate`` of the f32), as the port builds and launches them,
  beside a ``copy_`` of its 18.55 MB.
* the residue of the codes' ``evict_last`` lines: ``torch.add(x, u)``
  timed after the write flush before any hinted launch, after 50 hinted
  quantize launches into one buffer, after one dequantize of that buffer
  (its ``evict_first`` reads) and after the buffer is overwritten by
  ``zero_``.  Lines that outlive the flush leave fewer dirty lines for
  the timed launch to write back, so a faster add marks them.

It prints one JSON line per case with the card's name and power limit.
Run from the repository root on a machine with a CUDA card:

    python3 tools/l2_probe.py [case prefix ...]

With prefixes it times only the cases whose names start with one of them
(and skips the residue probe); every case is still checked.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


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


def quantizer_cases(torch, tref, lib, x, u, bits=8):
    """quantize, dequantize and the pair through ``lib``'s C entry points
    (the wrappers' arguments, on the current stream)."""
    n, inv_gain = x.numel(), 1.0 / 2 ** (bits - 1)

    def quantize():
        codes = torch.empty(x.shape, dtype=torch.int32, device=x.device)
        err = lib.repro_quantize_codes(x.data_ptr(), u.data_ptr(),
                                       codes.data_ptr(), n,
                                       *tref.quant_step(bits, 1.0), bits, 1,
                                       torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return codes

    def dequantize(codes):
        out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
        err = lib.repro_dequantize_codes(codes.data_ptr(), out.data_ptr(), n,
                                         inv_gain,
                                         torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out

    codes = quantize()
    return {"stochastic_quantize_codes": quantize,
            "dequantize_codes": lambda: dequantize(codes),
            "fake_quant_pair": lambda: dequantize(quantize())}


def ring_front_cases(torch, tref, lib, x, u, bits=8):
    """quantize_pack_chunk (one chunk, native lane) and the chunk then one
    repack hop through ``lib``'s C entry points."""
    (K, D), g = x.shape, 2 ** (bits - 1)
    Wc = -(-D // (32 // bits))

    def chunk():
        words = torch.empty((K, Wc), dtype=torch.int32, device=x.device)
        codes = torch.empty((K, D), dtype=torch.int32, device=x.device)
        err = lib.repro_quantize_pack_chunk(
            x.data_ptr(), u.data_ptr(), words.data_ptr(), codes.data_ptr(), K,
            D, 1, D, Wc, bits, g, *tref.quant_step(bits, 1.0), bits, 1,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return words, codes

    def pair():
        words, codes = chunk()
        err = lib.repro_repack(words.data_ptr(), codes.data_ptr(), K, D, Wc, 1,
                               K, 1, bits, g,
                               torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return codes

    return {"quantize_pack_chunk": chunk, "chunk_repack_pair": pair}


def rsag_cases(torch, lib, hop_sums, summed, sums2, D, bits=8, lane=12):
    """rsag's pack_sums, its two chains and unpack_dequantize at rsag's and
    the packed psum's shapes, and pack_sums at the two-axis ring's level
    change (``sums2``, lane 9), through ``lib``'s C entry points."""
    (C, chunk), g = hop_sums.shape, 2 ** (bits - 1)
    bias, cpw = 2 ** (lane - 1), 32 // lane
    Wh, Wp = -(-chunk // cpw), summed.numel()
    acc = hop_sums.clone()
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def sums():
        words = torch.empty((C, Wh), dtype=torch.int32, device=hop_sums.device)
        err = lib.repro_pack_sums(hop_sums.data_ptr(), words.data_ptr(), C,
                                  chunk, Wh, lane, bias, stream())
        assert err == 0, err
        return words

    def unpack(words, rows, size, b):
        out = torch.empty((rows, size), dtype=torch.float32,
                          device=words.device)
        err = lib.repro_unpack_dequantize(words.data_ptr(), out.data_ptr(),
                                          rows, size, words.shape[-1], lane,
                                          b, 1.0 / g, stream())
        assert err == 0, err
        return out

    def hop():
        words = sums()
        err = lib.repro_repack(words.data_ptr(), acc.data_ptr(), C, chunk, Wh,
                               1, C, 1, lane, bias, stream())
        assert err == 0, err
        return acc

    def level_change():
        W9 = -(-D // 3)
        words = torch.empty((C, W9), dtype=torch.int32, device=sums2.device)
        err = lib.repro_pack_sums(sums2.data_ptr(), words.data_ptr(), C, D, W9,
                                  9, 2 * g, stream())
        assert err == 0, err
        return words

    hop_words = sums()
    return {"pack_sums": level_change, "pack_sums@rsag_hop": sums,
            "unpack_dequantize": lambda: unpack(summed, 1, D, C * g),
            "unpack_dequantize@rsag": lambda: unpack(hop_words, C, chunk, bias),
            "rsag_hop_pair": hop,
            "rsag_tail_pair": lambda: unpack(sums(), C, chunk, bias)}


def residue_probe(torch, ops, tref, build, x, u, flush, card):
    """``torch.add(x, u)`` after the write flush, before any hinted launch
    and after each step of the codes' hinted life (module docstring)."""
    add_ms = lambda: single_ms(torch, lambda: torch.add(x, u), flush)
    residue = {"before": add_ms()}
    kept = ops.stochastic_quantize_codes(x, u, 8)
    lib = build.library("quantize")
    for _ in range(50):
        lib.repro_quantize_codes(x.data_ptr(), u.data_ptr(), kept.data_ptr(),
                                 kept.numel(), *tref.quant_step(8, 1.0), 8, 1,
                                 torch.cuda.current_stream().cuda_stream)
    residue["after_quantize"] = add_ms()
    ops.dequantize_codes(kept, 8)
    residue["after_dequantize_read"] = add_ms()
    kept.zero_()
    residue["after_zero_"] = add_ms()
    print(json.dumps({"probe": "evict_last_residue",
                      "add_x_u_ms_write_flush": residue, "card": card}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("l2_probe: no CUDA device; it needs a card")
    from chip_smoke import copy_yardstick, time_back_to_back_ms
    from repro_torch.core import aggregation as agg
    from repro_torch.core import quantization as quant
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import ref as tref

    only = tuple(sys.argv[1:])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.splitlines()[0].strip()
    C, D = 10, 421_642
    gen = torch.Generator(device="cuda").manual_seed(11)
    codes = torch.randint(-128, 128, (C, D), generator=gen, device="cuda",
                          dtype=torch.int32)
    words = quant.pack_codes(codes, 8)
    acc, other = codes.clone(), codes.clone()
    x = (torch.rand((C, D), generator=gen, device="cuda") - 0.5) * 0.02
    u = torch.rand((C, D), generator=gen, device="cuda")
    buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")  # 256 MB
    flushes = {"write": buf.zero_, "read": buf.sum}
    if not only:
        residue_probe(torch, ops, tref, build, x, u, flushes["write"], card)
    cases = {"repack_hop": lambda: ops.repack(words, acc, 8, D, hop=1),
             "copy_33_7MB": lambda: acc.copy_(other),
             "add_x_u": lambda: torch.add(x, u)}
    libs = {"l2_hints": build.library("quantize"),
            "plain_policy": build.variant("quantize", "REPRO_PLAIN_CACHE_POLICY")}
    pack_libs = {"l2_hints": build.library("pack"),
                 "plain_policy": build.variant("pack", "REPRO_PLAIN_CACHE_POLICY")}
    for policy, lib in libs.items():
        for name, fn in quantizer_cases(torch, tref, lib, x, u).items():
            cases[f"{name}@{policy}"] = fn
    for policy, lib in pack_libs.items():
        for name, fn in ring_front_cases(torch, tref, lib, x, u).items():
            cases[f"{name}@{policy}"] = fn
    chunk = -(-D // C)
    hop_sums = torch.randint(-1280, 1271, (C, chunk), generator=gen,
                             device="cuda", dtype=torch.int32)
    summed = agg.sum_words(ops.quantize_pack(x, u, 8, lane_bits=12))
    sums2 = torch.randint(-256, 255, (C, D), generator=gen, device="cuda",
                          dtype=torch.int32)
    rsag = {policy: rsag_cases(torch, lib, hop_sums, summed, sums2, D)
            for policy, lib in pack_libs.items()}
    kw = dict(lane_bits=12, bias=2 ** 11)
    want_words = tref.pack_sums_ref(hop_sums, 8, **kw)
    want = {"pack_sums": tref.pack_sums_ref(sums2, 8, lane_bits=9, sum_of=2),
            "pack_sums@rsag_hop": want_words,
            "unpack_dequantize": tref.unpack_dequantize_ref(
                summed, 8, D, lane_bits=12, sum_of=C).view(1, D),
            "unpack_dequantize@rsag": tref.unpack_dequantize_ref(
                want_words, 8, chunk, **kw),
            "rsag_tail_pair": tref.unpack_dequantize_ref(
                want_words, 8, chunk, **kw),
            "rsag_hop_pair": tref.repack_ref(want_words, hop_sums.clone(), 8,
                                             chunk, hop=1, **kw)}
    for policy, fns in rsag.items():
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            assert torch.equal(got, want[name]), (name, policy)
            cases[f"{name}@{policy}"] = fn
    pair = cases["fake_quant_pair@plain_policy"]()
    torch.cuda.synchronize()
    assert torch.equal(pair, cases["fake_quant_pair@l2_hints"]())
    assert torch.equal(pair, tref.dequantize_ref(
        tref.stochastic_quantize_ref(x, u, 8), 8))
    hop = cases["chunk_repack_pair@plain_policy"]()
    torch.cuda.synchronize()
    assert torch.equal(hop, cases["chunk_repack_pair@l2_hints"]())
    front, acc0 = tref.quantize_pack_chunk_ref(x, u, 8, num_chunks=1)
    assert torch.equal(hop, tref.repack_ref(front.view(C, -1), acc0.view(C, D),
                                            8, D, hop=1))
    w = torch.rand(C, generator=gen, device="cuda") * 0.1
    lam = (torch.arange(C, device="cuda") != 3).float()    # one packet lost
    deq = tref.dequantize_ref(codes, 8)
    want = {"masked_aggregate": tref.masked_aggregate_ref(x, w),
            "uplink_aggregate_pair": tref.masked_aggregate_ref(deq, w * lam)}
    cases["copy_18_55MB"] = copy_yardstick(torch, 4.0 * C * D + 4.0 * D + 4.0 * C)[1]
    for name, fn in {"masked_aggregate": lambda: ops.masked_aggregate(x, w),
                     "uplink_aggregate_pair": lambda: ops.masked_aggregate(
                         ops.dequantize_codes(codes, 8),
                         (w * lam).float().contiguous())}.items():
        got = fn()
        torch.cuda.synchronize()
        assert torch.equal(got, want[name]), name
        cases[name] = fn
    for name, fn in cases.items():
        if only and not name.startswith(only):
            continue
        print(json.dumps({"probe": name, **{
            f"ms_{k}_flush": single_ms(torch, fn, f) for k, f in flushes.items()},
            "ms_back_to_back": time_back_to_back_ms(torch, fn),
            "ms_is": "median of 50 single launches after the flush",
            "ms_back_to_back_is": "mean of 50 launches back to back, L2 warm",
            "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
