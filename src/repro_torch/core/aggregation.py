"""Server-side aggregation of one round's client deltas (paper eq. 5/6) and
the cohort round's wire formats.

Simulator forms: the deltas arrive stacked as one flat (K, D) tensor
(clients × parameters in leaf order) and the model as its flat (D,) vector.

Collective forms (the cohort round) run in one of two forms.  Per rank
(:func:`aggregate_rank`, ``core.fl.make_dist_fl_round``): one process a
cohort, each collective a real one of ``core.comm.Comm``, as the
reference's under ``shard_map`` (see :func:`aggregate_rank`).  Stacked
(:func:`aggregate`, ``core.fl.make_fl_round``): one device holds every
cohort, the C cohorts the leading
dimension of every tensor, stacked row-major over the cohort grid
``axis_sizes`` (row p·K_data + d for ("pod", "data")).  Where the
reference runs one shard per cohort under ``shard_map``, the port reads
its collectives so:

  ``lax.psum`` over the cohort axes  -> a sum over the leading dimension
                                        (modulo 2^32 for packed words);
  ``lax.ppermute`` by h along axis a  -> row r reads the row of its group
                                        whose index on a is h less, mod K_a
                                        (``ops.repack``'s axis hop);
  ``lax.axis_index(a)``               -> (r // inner_a) mod K_a, inner_a
                                        the product of the later axes.

One launch of each kernel covers all cohorts.  A :class:`WirePlan` built
once by :func:`make_wire_plan` resolves "auto", applies the degenerate
fallbacks and prices the wire, exactly as the reference's.  Wire formats:

  "paper"   quantize-dequantize each cohort's delta, f32 sum of the
            weighted survivors.  32 wire bits/param.
  "int"     the integer codes summed in the smallest int container that
            holds the cohort sum.
  "packed"  codes biased and bit-packed into 32-bit words with a
            ceil(log2 C)-bit guard per lane, so one modular word sum adds
            every lane carry-free (``quantize_pack`` / ``unpack_dequantize``).
  "ring"    codes packed at the native lane and passed K-1 hops round the
            ring of each non-trivial axis, each hop unpacked into an int32
            accumulator (``repack``); between axes the partial sums of m
            codes are re-packed at lane bits+ceil(log2 m) (``pack_sums``).
            ``QuantConfig.pipeline_hops`` picks the front-end: one
            ``quantize_pack_chunk`` launch (True) or ``quantize_pack`` and a
            repack from zero (False).  Same codes, same sum.
  "rsag"    reduce-scatter + all-gather per non-trivial axis: the vector
            splits into K chunks, hop h ships one chunk of partial sums at
            a growing lane (``pack_sums``, ``repack``), and the gather
            forwards the finished chunks unchanged.  Front-end: one
            ``quantize_pack_chunk`` launch (``pipeline_hops``) or the
            quantizer and a ``pack_sums``.

Every quantized mode computes the same integer codes and the same exact
integer sum, and dequantizes that sum by the same multiply,
``codes · float32(clip/G)``, so "int", "packed", "ring" and "rsag" give
bit-identical aggregates at every clip.  (The reference's pure path
divides and its Pallas kernels multiply, so at a clip that is not a power
of two its modes can differ from each other by up to 2 ulp — ROADMAP C;
the port is not held to that.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import COLLECTIVE_CHOICES, QuantConfig
from repro_torch.core import quantization as quant
from repro_torch.kernels import ops
from repro_torch.obs.trace import phase_span

EPS = 1e-12

#: concrete wire formats ("auto" is a resolution rule, not a format)
COLLECTIVES = tuple(m for m in COLLECTIVE_CHOICES if m != "auto")
#: candidate order for "auto" (first wins wire-bit ties)
AUTO_ORDER = ("ring", "rsag", "packed", "int")


def naive_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                    lambdas: torch.Tensor) -> torch.Tensor:
    """eq. 5 with drops zeroed: w + (1/K) Σ λ_k Δ_k.  Plain torch: the sum
    is divided by K, not by the surviving weight, so it is not the
    ``masked_aggregate`` kernel's function."""
    K = lambdas.shape[0]
    return w + (deltas * lambdas[:, None]).sum(0) / K


def error_aware_aggregate(w: torch.Tensor, deltas: torch.Tensor,
                          alphas: torch.Tensor,
                          lambdas: torch.Tensor) -> torch.Tensor:
    """eq. 6: surviving updates renormalized by the surviving data mass,
    w + Σ α_k λ_k Δ_k / max(Σ α_k λ_k, eps), through the kernel."""
    wts = (alphas * lambdas).float().contiguous()
    return w + ops.masked_aggregate(deltas.contiguous(), wts, eps=EPS)


# ---------------------------------------------------------------------------
# wire accounting: what actually hits the wire per mode (incl. fallbacks)
# ---------------------------------------------------------------------------

def _int_container(bits: int, num_shards: int) -> torch.dtype:
    """Smallest signed int dtype holding Σ over shards of ±2^(bits-1) codes."""
    need = bits - 1 + math.ceil(math.log2(max(num_shards, 2))) + 1
    if need <= 7:
        return torch.int8
    if need <= 15:
        return torch.int16
    return torch.int32


def _prod(sizes: Sequence[int]) -> int:
    return int(math.prod(int(s) for s in sizes))


def resolve_auto(qcfg: QuantConfig, axis_sizes: Sequence[int]) -> str:
    """The byte-minimal concrete mode for (bits, axis_sizes): the least
    :func:`wire_bits_per_param` over ``AUTO_ORDER`` (ties to the earlier),
    collapsed through :func:`effective_wire_format`."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if not (qcfg.enabled and qcfg.quantize_uplink):
        return "paper"
    best = min(AUTO_ORDER,
               key=lambda m: wire_bits_per_param(m, qcfg, axis_sizes))
    return effective_wire_format(best, qcfg, _prod(axis_sizes),
                                 axis_sizes=axis_sizes)


def effective_wire_format(collective: str, qcfg: QuantConfig,
                          num_shards: int, *,
                          axis_sizes: Sequence[int] | None = None) -> str:
    """The format that actually crosses the wire after degenerate fallbacks:
    "paper" when the uplink is not quantized, "int" when a packed lane
    would exceed 32 bits; "auto" first resolves (``axis_sizes`` defaults to
    the single axis ``(num_shards,)``)."""
    if collective == "auto":
        collective = resolve_auto(
            qcfg, axis_sizes if axis_sizes is not None else (num_shards,))
    if collective not in COLLECTIVES:
        raise ValueError(f"unknown collective {collective!r}")
    if collective == "paper" or not (qcfg.enabled and qcfg.quantize_uplink):
        return "paper"
    if (collective in ("packed", "ring", "rsag")
            and quant.packed_lane_bits(qcfg.bits, num_shards) > 32):
        return "int"
    return collective


def wire_phase_bits_per_param(collective: str, qcfg: QuantConfig,
                              axis_sizes: Sequence[int]) -> Dict[str, float]:
    """Per-device wire bits per parameter by phase: {"psum": b} for the
    one-shot modes, {"ring_hops": b} for the ring, {"reduce_scatter",
    "all_gather"} for rsag.  Values sum to :func:`wire_bits_per_param`."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    num_shards = _prod(axis_sizes)
    eff = effective_wire_format(collective, qcfg, num_shards,
                                axis_sizes=axis_sizes)
    if eff == "paper":
        return {"psum": 32.0}
    if eff == "int":
        container = _int_container(qcfg.bits, num_shards)
        return {"psum": {torch.int8: 8.0, torch.int16: 16.0,
                         torch.int32: 32.0}[container]}
    if eff == "packed":
        lane = quant.packed_lane_bits(qcfg.bits, num_shards)
        return {"psum": 32.0 / (32 // lane)}
    if eff == "ring":
        total, m = 0.0, 1
        for k in axis_sizes:
            if k <= 1:
                continue
            lane = quant.packed_lane_bits(qcfg.bits, m)
            total += (k - 1) * 32.0 / (32 // lane)
            m *= k
        return {"ring_hops": total}
    rs, ag, m = 0.0, 0.0, 1  # rsag: chunk = 1/K of the vector per hop
    for k in axis_sizes:
        if k <= 1:
            continue
        for h in range(1, k):
            lane = quant.packed_lane_bits(qcfg.bits, m * h)
            rs += 32.0 / (32 // lane) / k
        lane_k = quant.packed_lane_bits(qcfg.bits, m * k)
        ag += (k - 1) * 32.0 / (32 // lane_k) / k
        m *= k
    return {"reduce_scatter": rs, "all_gather": ag}


def wire_bits_per_param(collective: str, qcfg: QuantConfig,
                        axis_sizes: Sequence[int]) -> float:
    """Per-device wire bits per parameter actually sent (after fallbacks),
    summed over every hop and phase."""
    return sum(wire_phase_bits_per_param(collective, qcfg,
                                         axis_sizes).values())


@dataclass(frozen=True)
class WirePlan:
    """Static plan for one cohort aggregation: ``mode`` as asked (maybe
    "auto"), ``resolved`` the concrete pick, ``effective`` the format on the
    wire after fallbacks (what :func:`aggregate` runs and ``wire_bits``
    prices)."""
    mode: str
    resolved: str
    effective: str
    quant: QuantConfig
    axes: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    num_shards: int
    wire_bits: float


def make_wire_plan(collective: str, qcfg: QuantConfig, axes: Sequence[str],
                   axis_sizes: Sequence[int]) -> WirePlan:
    """Resolve "auto", apply the fallbacks and price the wire."""
    axes = tuple(axes)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    num_shards = _prod(axis_sizes)
    resolved = (resolve_auto(qcfg, axis_sizes) if collective == "auto"
                else collective)
    if resolved not in COLLECTIVES:
        raise ValueError(f"unknown collective {resolved!r}")
    effective = effective_wire_format(resolved, qcfg, num_shards,
                                      axis_sizes=axis_sizes)
    return WirePlan(mode=collective, resolved=resolved, effective=effective,
                    quant=qcfg, axes=axes, axis_sizes=axis_sizes,
                    num_shards=num_shards,
                    wire_bits=wire_bits_per_param(resolved, qcfg, axis_sizes))


# ---------------------------------------------------------------------------
# plan execution, cohort-stacked: every tensor leads with the C cohorts
# ---------------------------------------------------------------------------

def sum_words(words: torch.Tensor) -> torch.Tensor:
    """The packed psum: a sum over the cohort rows of 32-bit words, modulo
    2^32, computed in int64."""
    return quant.to_int32_pattern(quant.from_int32_pattern(words).sum(0))


def aggregate(plan: WirePlan, delta: torch.Tensor, alpha: float,
              lam: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
    """The planned collective over C stacked cohorts.

    delta (C, D) f32 per-cohort deltas; ``alpha`` each cohort's data weight;
    lam (C,) packet successes; u (C, D) the uplink rounding noise (None for
    nearest rounding or an unquantized uplink).  Returns the aggregated
    delta (D,) that every cohort holds after the collective.
    """
    if delta.dim() != 2 or lam.shape != (delta.shape[0],):
        raise ValueError(f"need delta (C, D) and lam (C,), got "
                         f"{tuple(delta.shape)} and {tuple(lam.shape)}")
    if delta.shape[0] != plan.num_shards:
        raise ValueError(f"{delta.shape[0]} cohort rows, plan has "
                         f"{plan.num_shards} shards")
    # α·λ in float32, as the reference's f32 scalar product
    w = lam.to(torch.float32) * float(np.float32(alpha))
    if plan.effective == "paper":
        qcfg = plan.quant
        if qcfg.enabled and qcfg.quantize_uplink:
            with phase_span("wire/quantize_pack"):
                delta = quant.quantize(delta, u, qcfg)
        with phase_span("wire/psum"):
            den = torch.clamp(w.sum(), min=EPS)
            return (delta.to(torch.float32) * w[:, None]).sum(0) / den
    with phase_span("wire/psum"):
        den = torch.clamp(w.sum(), min=EPS)
    scale = float(plan.num_shards)
    with phase_span("wire/quantize_pack"):
        # the λ-weighting is the quantizer's input: the wire's front-end
        x = delta.to(torch.float32) * (w * scale)[:, None]
    deq = _REDUCERS[plan.effective](plan, x, u)   # Σ codes · clip/G, (D,)
    with phase_span("wire/unpack_dequant"):
        return deq / (den * scale)


def _reduce_int(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    """The codes summed in the smallest int container (one quantize and one
    dequantize launch)."""
    qcfg = plan.quant
    with phase_span("wire/quantize_pack"):
        codes = quant.quantize_codes(x, u, qcfg.bits, clip=qcfg.clip,
                                     stochastic=qcfg.stochastic)
    container = _int_container(qcfg.bits, plan.num_shards)
    with phase_span("wire/psum"):
        total = codes.to(container).sum(0, dtype=container).to(torch.int32)
    with phase_span("wire/unpack_dequant"):
        return quant.dequantize_codes(total, qcfg.bits, clip=qcfg.clip)


def _reduce_packed(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    """Guard-lane word sum: ``quantize_pack`` over all cohorts, the modular
    sum, one ``unpack_dequantize`` of the replicated result.  Dropped
    cohorts quantize a zero delta to the zero code, so every cohort adds
    exactly one +G per lane and the un-bias is C·G."""
    qcfg = plan.quant
    lane = quant.packed_lane_bits(qcfg.bits, plan.num_shards)
    with phase_span("wire/quantize_pack"):
        words = ops.quantize_pack(x, _contig(u), qcfg.bits, clip=qcfg.clip,
                                  lane_bits=lane, stochastic=qcfg.stochastic)
    with phase_span("wire/psum"):
        total = sum_words(words)
    with phase_span("wire/unpack_dequant"):
        return ops.unpack_dequantize(total, qcfg.bits, x.shape[1],
                                     clip=qcfg.clip, lane_bits=lane,
                                     sum_of=plan.num_shards)


def _cohort_levels(plan: WirePlan) -> Tuple[Tuple[str, int, int], ...]:
    """(axis, K, inner) of each non-trivial cohort axis in plan order: K
    entries, ``inner`` stacked rows per step (the product of the later
    axes' sizes)."""
    sizes = plan.axis_sizes
    return tuple((a, k, _prod(sizes[i + 1:]))
                 for i, (a, k) in enumerate(zip(plan.axes, sizes)) if k > 1)


def ring_sum(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    """The native-width ring over every non-trivial cohort axis, in plan
    order: (C, D) int32 where every row ends with the full code sum.  On an
    axis of K entries, hop h adds the packed words of the row h steps back
    along it, as ``ppermute`` by one hop h times delivers them; between
    axes the partial sums of m codes are re-packed at lane
    bits+ceil(log2 m) with the sum_of·G bias (``pack_sums``)."""
    qcfg = plan.quant
    bits = qcfg.bits
    C, n = x.shape
    with phase_span("wire/quantize_pack"):
        if qcfg.pipeline_hops:
            words, codes = ops.quantize_pack_chunk(
                x, _contig(u), bits, clip=qcfg.clip, lane_bits=bits,
                stochastic=qcfg.stochastic, num_chunks=1)
            buf, acc = words.reshape(C, -1), codes.reshape(C, n)
        else:
            buf = ops.quantize_pack(x, _contig(u), bits, clip=qcfg.clip,
                                    lane_bits=bits,
                                    stochastic=qcfg.stochastic)
            # own codes: the exact unpack of the freshly packed words
            acc = ops.repack(buf, torch.zeros((C, n), dtype=torch.int32,
                                              device=x.device),
                             bits, n, hop=0, lane_bits=bits)
    m = 1   # codes summed in each accumulator entry so far
    with phase_span("wire/ring_hops"):
        for _, K, inner in _cohort_levels(plan):
            lane = quant.packed_lane_bits(bits, m)
            if m > 1:
                buf = ops.pack_sums(acc, bits, lane_bits=lane, sum_of=m)
            for h in range(1, K):
                ops.repack(buf, acc, bits, n, hop=h, lane_bits=lane,
                           sum_of=m, axis_size=K, inner=inner)
            m *= K
    return acc


def _reduce_ring(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    """Every row of the ring's accumulator holds the same sum: dequantize
    row 0."""
    qcfg = plan.quant
    acc = ring_sum(plan, x, u)
    with phase_span("wire/unpack_dequant"):
        return quant.dequantize_codes(acc[0], qcfg.bits, clip=qcfg.clip)


def _gather_chunks(vals: torch.Tensor, K: int, inner: int, n: int,
                   r: torch.Tensor) -> torch.Tensor:
    """The all-gather's layout: vals (R, C) holds, in the row at index idx
    on the axis, the finished chunk (idx + 1) mod K; every row of the group
    takes chunk j from the row at index (j - 1) mod K.  Returns the rows
    ``r`` gather, (len(r), n)."""
    C = vals.shape[1]
    base = r - ((r // inner) % K) * inner          # the group's index-0 row
    j = torch.arange(K, device=vals.device)
    src = base[:, None] + ((j - 1) % K * inner)[None, :]
    return vals[src].reshape(len(r), K * C)[:, :n]


def rsag_sum(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    """Reduce-scatter + all-gather over every non-trivial cohort axis, in
    plan order: (1, D) f32, the dequantized code sum that every row holds
    at the end.  The last gather moves row 0 alone (the aggregate reads
    one row: a (C, D) float32 copy less at the round's peak).

    A level over an axis of K entries splits each row's vector of partial
    sums of ``unit`` codes into K chunks of ceil(D/K) (the pad tail rides
    as zero codes).  Scatter hop h packs every row's running chunk at lane
    bits+ceil(log2(unit·h)) with the lane-symmetric ``lane_bias``
    (``pack_sums``) and adds the words of the row one step back along the
    axis into row r's chunk (idx_r - h) mod K (``repack``).  The row at
    index idx then holds the full sum of chunk (idx + 1) mod K; the
    gather forwards the packed finished chunks unchanged, so one unpack of
    every row's words gives every chunk.  A level before the last unpacks
    into int32 codes (``repack`` into a zero accumulator), the last one
    straight into f32 (``unpack_dequantize``).

    Front-end: under ``pipeline_hops`` one ``quantize_pack_chunk`` launch
    gives level 0's chunks and hop 1's payload; otherwise the quantizer and
    a ``pack_sums``."""
    qcfg = plan.quant
    bits = qcfg.bits
    R, n = x.shape
    levels = _cohort_levels(plan)
    rows = torch.arange(R, device=x.device)
    front = None
    with phase_span("wire/quantize_pack"):
        if qcfg.pipeline_hops and levels:
            lane0 = quant.packed_lane_bits(bits, 1)
            front = ops.quantize_pack_chunk(
                x, _contig(u), bits, clip=qcfg.clip, lane_bits=lane0,
                stochastic=qcfg.stochastic, num_chunks=levels[0][1],
                bias=quant.lane_bias(lane0))
        else:
            codes = quant.quantize_codes(x, u, bits, clip=qcfg.clip,
                                         stochastic=qcfg.stochastic)
    if not levels:
        with phase_span("wire/unpack_dequant"):
            return quant.dequantize_codes(codes, bits, clip=qcfg.clip)
    unit = 1
    for li, (_, K, inner) in enumerate(levels):
        C = -(-n // K)
        idx = (rows // inner) % K
        with phase_span("wire/reduce_scatter"):
            if li == 0 and front is not None:
                words, chunks = front
            else:
                chunks = torch.nn.functional.pad(codes, (0, K * C - n))
                chunks = chunks.reshape(R, K, C)
            carry = chunks[rows, idx]
            for h in range(1, K):
                lane = quant.packed_lane_bits(bits, unit * h)
                bias = quant.lane_bias(lane)
                if h == 1 and li == 0 and front is not None:
                    payload = words[rows, idx]   # the own chunk, pre-packed
                else:
                    payload = ops.pack_sums(carry, bits, lane_bits=lane,
                                            bias=bias)
                carry = chunks[rows, (idx - h) % K]
                ops.repack(payload, carry, bits, C, hop=1, lane_bits=lane,
                           bias=bias, axis_size=K, inner=inner)
        with phase_span("wire/all_gather"):
            lane = quant.packed_lane_bits(bits, unit * K)
            bias = quant.lane_bias(lane)
            buf = ops.pack_sums(carry, bits, lane_bits=lane, bias=bias)
            last = li == len(levels) - 1
            if last:
                vals = ops.unpack_dequantize(buf, bits, C, clip=qcfg.clip,
                                             lane_bits=lane, bias=bias)
            else:
                vals = ops.repack(buf, torch.zeros((R, C), dtype=torch.int32,
                                                   device=x.device),
                                  bits, C, hop=0, lane_bits=lane, bias=bias)
            codes = _gather_chunks(vals, K, inner, n,
                                   rows[:1] if last else rows)
        unit *= K
    return codes


def _reduce_rsag(plan: WirePlan, x: torch.Tensor, u) -> torch.Tensor:
    return rsag_sum(plan, x, u)[0]


def _contig(u: torch.Tensor | None) -> torch.Tensor | None:
    return u.contiguous() if u is not None else None


_REDUCERS = {"int": _reduce_int, "packed": _reduce_packed,
             "ring": _reduce_ring, "rsag": _reduce_rsag}


# ---------------------------------------------------------------------------
# plan execution per rank: one cohort a process, real collectives
# ---------------------------------------------------------------------------

def aggregate_rank(plan: WirePlan, comm, delta: torch.Tensor, alpha: float,
                   lam: torch.Tensor, u: torch.Tensor | None) -> torch.Tensor:
    """The planned collective from one rank of ``comm`` (``core.comm.Comm``).

    delta (1, D) f32 this rank's cohort delta; ``alpha`` its data weight;
    lam (1,) its packet success; u (1, D) its uplink noise (None for
    nearest rounding or an unquantized uplink).  Returns the aggregated
    delta (D,), the same on every rank.  The same kernels as
    :func:`aggregate` run on (1, ·) rows, and every collective crosses
    between processes:

      "paper"   ``psum`` of w·Δ in float32 (the order of that sum is the
                backend's: equal to the stacked sum within rounding);
      "int"     the codes' ``psum`` in the plan's container: int8 and int32
                as they are; int16, which neither NCCL nor gloo sums, as two
                lanes of each int32 word, each code biased by +G, so a lane's
                sum of C biased codes stays below 2^15 by the container's
                choice and never carries into the next (the container's two
                bytes a code cross the wire, not four);
      "packed"  one ``psum`` of the guard-lane words, modulo 2^32;
      "ring"    K - 1 hops of the packed words along each non-trivial axis
                (``Comm.forward``), each unpacked into the int32 accumulator
                (``repack`` at hop 0); between axes ``pack_sums``;
      "rsag"    per axis, K - 1 scatter hops of one chunk each at a growing
                lane (``pack_sums``, ``repack``), then a gather that passes
                the packed finished chunks on; rank index idx ends the
                scatter with chunk (idx + 1) mod K, as the reference's.

    The weights' sum (the renormalizing denominator) comes from a
    ``gather`` of the C weights, summed in cohort order as :func:`aggregate`
    sums them, so every quantized format is bit-identical to the stacked
    form on the same rows.
    """
    if delta.dim() != 2 or delta.shape[0] != 1 or lam.shape != (1,):
        raise ValueError(f"need delta (1, D) and lam (1,), got "
                         f"{tuple(delta.shape)} and {tuple(lam.shape)}")
    if comm.axis_sizes != plan.axis_sizes or comm.axes != plan.axes:
        raise ValueError(f"plan over {plan.axes} {plan.axis_sizes}, comm "
                         f"over {comm.axes} {comm.axis_sizes}")
    w = lam.to(torch.float32) * float(np.float32(alpha))
    with phase_span("wire/psum"):
        den = torch.clamp(comm.gather(w).reshape(-1).sum(), min=EPS)
    if plan.effective == "paper":
        qcfg = plan.quant
        if qcfg.enabled and qcfg.quantize_uplink:
            with phase_span("wire/quantize_pack"):
                delta = quant.quantize(delta, u, qcfg)
        with phase_span("wire/psum"):
            return comm.psum(delta.to(torch.float32) * w[:, None])[0] / den
    scale = float(plan.num_shards)
    with phase_span("wire/quantize_pack"):
        x = delta.to(torch.float32) * (w * scale)[:, None]
    deq = _RANK_REDUCERS[plan.effective](plan, comm, x, u)
    with phase_span("wire/unpack_dequant"):
        return deq / (den * scale)


def _rank_int(plan: WirePlan, comm, x: torch.Tensor, u) -> torch.Tensor:
    qcfg = plan.quant
    with phase_span("wire/quantize_pack"):
        codes = quant.quantize_codes(x, u, qcfg.bits, clip=qcfg.clip,
                                     stochastic=qcfg.stochastic)[0]
    container = _int_container(qcfg.bits, plan.num_shards)
    with phase_span("wire/psum"):
        if container != torch.int16:
            total = comm.psum(codes.to(container)).to(torch.int32)
        else:
            n, g = codes.shape[0], 2 ** (qcfg.bits - 1)
            lanes = torch.nn.functional.pad(codes + g, (0, n % 2), value=g)
            words = comm.psum(lanes.to(torch.int16).view(torch.int32))
            total = (words.view(torch.int16)[:n].to(torch.int32)
                     - plan.num_shards * g)
    with phase_span("wire/unpack_dequant"):
        return quant.dequantize_codes(total, qcfg.bits, clip=qcfg.clip)


def _rank_packed(plan: WirePlan, comm, x: torch.Tensor, u) -> torch.Tensor:
    qcfg = plan.quant
    lane = quant.packed_lane_bits(qcfg.bits, plan.num_shards)
    with phase_span("wire/quantize_pack"):
        words = ops.quantize_pack(x, _contig(u), qcfg.bits, clip=qcfg.clip,
                                  lane_bits=lane, stochastic=qcfg.stochastic)
    with phase_span("wire/psum"):
        total = comm.psum(words)[0]
    with phase_span("wire/unpack_dequant"):
        return ops.unpack_dequantize(total, qcfg.bits, x.shape[1],
                                     clip=qcfg.clip, lane_bits=lane,
                                     sum_of=plan.num_shards)


def _rank_ring(plan: WirePlan, comm, x: torch.Tensor, u) -> torch.Tensor:
    """The ring from one rank: its packed words pass K - 1 hops round each
    axis, every payload added into its accumulator as it lands."""
    qcfg = plan.quant
    bits = qcfg.bits
    n = x.shape[1]
    with phase_span("wire/quantize_pack"):
        if qcfg.pipeline_hops:
            words, codes = ops.quantize_pack_chunk(
                x, _contig(u), bits, clip=qcfg.clip, lane_bits=bits,
                stochastic=qcfg.stochastic, num_chunks=1)
            buf, acc = words.reshape(1, -1), codes.reshape(1, n)
        else:
            buf = ops.quantize_pack(x, _contig(u), bits, clip=qcfg.clip,
                                    lane_bits=bits,
                                    stochastic=qcfg.stochastic)
            acc = ops.repack(buf, torch.zeros((1, n), dtype=torch.int32,
                                              device=x.device),
                             bits, n, hop=0, lane_bits=bits)
    m = 1
    with phase_span("wire/ring_hops"):
        for axis, K, _ in _cohort_levels(plan):
            lane = quant.packed_lane_bits(bits, m)
            if m > 1:
                buf = ops.pack_sums(acc, bits, lane_bits=lane, sum_of=m)
            for recv in comm.forward(buf, axis, pipelined=qcfg.pipeline_hops):
                ops.repack(recv, acc, bits, n, hop=0, lane_bits=lane,
                           sum_of=m)
            m *= K
    with phase_span("wire/unpack_dequant"):
        return quant.dequantize_codes(acc[0], bits, clip=qcfg.clip)


def _rank_rsag(plan: WirePlan, comm, x: torch.Tensor, u) -> torch.Tensor:
    """Reduce-scatter + all-gather from one rank, level by level (see
    :func:`rsag_sum` for the lanes and biases): the scatter's hop h packs
    the running chunk, sends it on and adds the payload from one step back
    into chunk (idx - h) mod K; the gather passes the packed finished
    chunks on (``Comm.forward``) into their slots of a (K, W) word tensor,
    unpacked at once: into int32 codes before the last level, straight to
    float32 after it (``unpack_dequantize``)."""
    qcfg = plan.quant
    bits = qcfg.bits
    n = x.shape[1]
    levels = _cohort_levels(plan)
    front = None
    with phase_span("wire/quantize_pack"):
        if qcfg.pipeline_hops and levels:
            lane0 = quant.packed_lane_bits(bits, 1)
            front = ops.quantize_pack_chunk(
                x, _contig(u), bits, clip=qcfg.clip, lane_bits=lane0,
                stochastic=qcfg.stochastic, num_chunks=levels[0][1],
                bias=quant.lane_bias(lane0))
        else:
            codes = quant.quantize_codes(x, u, bits, clip=qcfg.clip,
                                         stochastic=qcfg.stochastic)
    if not levels:
        with phase_span("wire/unpack_dequant"):
            return quant.dequantize_codes(codes[0], bits, clip=qcfg.clip)
    unit = 1
    for li, (axis, K, _) in enumerate(levels):
        C = -(-n // K)
        idx = comm.axis_index(axis)
        with phase_span("wire/reduce_scatter"):
            if li == 0 and front is not None:
                words, chunks = front[0][0], front[1][0]
            else:
                chunks = torch.nn.functional.pad(codes, (0, K * C - n))
                chunks = chunks.reshape(K, C)
            carry = chunks[idx:idx + 1]
            for h in range(1, K):
                lane = quant.packed_lane_bits(bits, unit * h)
                bias = quant.lane_bias(lane)
                if h == 1 and li == 0 and front is not None:
                    payload = words[idx:idx + 1]   # the own chunk, packed
                else:
                    payload = ops.pack_sums(carry, bits, lane_bits=lane,
                                            bias=bias)
                recv = comm.hop(payload, axis)
                j = (idx - h) % K
                carry = chunks[j:j + 1].clone()
                ops.repack(recv, carry, bits, C, hop=0, lane_bits=lane,
                           bias=bias)
        with phase_span("wire/all_gather"):
            lane = quant.packed_lane_bits(bits, unit * K)
            bias = quant.lane_bias(lane)
            buf = ops.pack_sums(carry, bits, lane_bits=lane, bias=bias)
            slots = torch.empty((K, buf.shape[1]), dtype=torch.int32,
                                device=x.device)
            slots[(idx + 1) % K] = buf[0]
            for t, recv in enumerate(comm.forward(
                    buf, axis, pipelined=qcfg.pipeline_hops), start=1):
                slots[(idx + 1 - t) % K] = recv[0]
            if li == len(levels) - 1:
                vals = ops.unpack_dequantize(slots, bits, C, clip=qcfg.clip,
                                             lane_bits=lane, bias=bias)
                return vals.reshape(-1)[:n]
            vals = ops.repack(slots, torch.zeros((K, C), dtype=torch.int32,
                                                 device=x.device),
                              bits, C, hop=0, lane_bits=lane, bias=bias)
            codes = vals.reshape(1, -1)[:, :n]
        unit *= K


_RANK_REDUCERS = {"int": _rank_int, "packed": _rank_packed,
                  "ring": _rank_ring, "rsag": _rank_rsag}
