"""Analytic per-device FLOP / HBM-byte / collective-byte model of a step
(the reference's ``repro.utils.flops``, the same arithmetic).

It counts the work of the computation the reference lowers, which the
port runs too: the chunked attention with its padding (no causal or
window block skipped, masking only), capacity-based MoE dispatch, the FL
round's local iterations, fwd+bwd = 3x fwd for training, the last
position's head in prefill, and the decode cache's read and write.  Every
family's branch is here (MLA, the shared experts, multi-token prediction,
the encoder-decoder, the recurrent blocks), as the port builds every
family.

Sharding model: per-device flops = Σ_component global_flops /
shards(component), where shards(component) honours the reference's
divisibility fallbacks (attention replicated over ``model`` when heads do
not divide it).  A mesh is the port's dict of axis sizes
(``launch.mesh``); one card is ``{"data": 1, "model": 1}``.  The wire terms
of the FL round price each mode with ``core.aggregation``'s
``effective_wire_format`` and ``wire_phase_bits_per_param``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

from repro_torch.config.base import Config
from repro_torch.configs.shapes import InputShape
from repro_torch.core import aggregation as agg_wire

Q_CHUNK, KV_CHUNK = 512, 1024  # common.attention's chunks


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class CostBreakdown:
    flops: Dict[str, float]
    param_bytes: float          # per-device parameter bytes (model dtype)
    act_bytes: float            # per-device activation traffic (approx)
    cache_bytes: float          # per-device KV/state cache traffic
    collective_bytes: Dict[str, float]

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return self.param_bytes + self.act_bytes + self.cache_bytes

    @property
    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())


def _mesh_sizes(mesh) -> Dict[str, int]:
    """A mesh's axis sizes: the port's meshes are dicts of them
    (``launch.mesh``)."""
    return dict(mesh)


def analytic_costs(config: Config, shape: InputShape, mesh, *,
                   step_kind: str, collective_mode: str = "paper") -> CostBreakdown:
    m = config.model
    ms = _mesh_sizes(mesh)
    model_par = ms.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        dp *= ms.get(a, 1)
    n_dev = model_par * dp
    model_par_orig = model_par
    dp_over_model = ((config.train.dp_over_model or config.train.zero_over_model)
                     and shape.kind == "train")
    zero = config.train.zero_over_model and shape.kind == "train"
    decode_2d = (config.train.decode_batch_2d and shape.kind == "decode"
                 and shape.global_batch % n_dev == 0)
    # fallback: cache sequence dim sharded over `model` (softmax-stat reduce)
    cache_seq_model = (config.train.decode_batch_2d and shape.kind == "decode"
                       and not decode_2d)
    if dp_over_model or decode_2d:
        # model axis acts as extra (within-cohort / decode-batch) data
        # parallelism for the COMPUTE; param placement handled separately
        dp *= model_par
        model_par = 1

    d, L, V, ff = m.d_model, m.n_layers, m.vocab_size, m.d_ff
    hd = m.resolved_head_dim
    H, KV = m.n_heads, m.n_kv_heads
    dtype_b = 2 if m.dtype == "bfloat16" else 4

    B, S = shape.global_batch, shape.seq_len
    is_train = shape.kind == "train"
    is_decode = shape.kind == "decode"
    # training fwd+bwd ~ 3x fwd matmul flops
    bwd = 3.0 if is_train else 1.0
    tokens = B * S if not is_decode else B        # tokens processed this step
    Sq = S if not is_decode else 1                # query length
    Skv = S                                        # context length

    attn_shardable = H % model_par == 0
    attn_par = model_par if attn_shardable else 1
    if cache_seq_model:
        attn_par = model_par_orig  # decode scores computed on local C chunk
    ff_par = model_par if ff % model_par == 0 else 1
    vocab_par = model_par if V % model_par == 0 else 1

    flops: Dict[str, float] = {}
    coll: Dict[str, float] = {}

    def window_of(kind: str) -> int:
        w = m.local_window if kind == "local" else m.attention_window
        return w

    # ---- per-layer costs -------------------------------------------------
    def attn_flops(window: int) -> float:
        if m.mla.enabled:
            a = m.mla
            dq = a.qk_nope_head_dim + a.qk_rope_head_dim
            proj = (d * a.q_lora_rank + a.q_lora_rank * H * dq
                    + d * (a.kv_lora_rank + a.qk_rope_head_dim))
            if is_decode:
                # absorbed: scores/out in latent space over the cache
                per_tok_cache = (H * (a.kv_lora_rank * dq)          # q absorb
                                 + H * a.kv_lora_rank * a.v_head_dim)
                cache_len = min(window, Skv) if window else Skv
                sc = H * cache_len * (a.kv_lora_rank + a.qk_rope_head_dim) * 2
                return 2 * tokens * (proj + per_tok_cache + H * a.v_head_dim * d / H * H) * bwd \
                    + 2 * tokens * sc
            proj += (a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim)
                     + H * a.v_head_dim * d)
            qk = _chunked_scores(Sq, Skv, window) * B * H * dq * 2 * 2
            return 2 * tokens * proj * bwd + qk * bwd
        proj = d * H * hd + 2 * d * KV * hd + H * hd * d
        if is_decode:
            cache_len = min(window, Skv) if window else Skv
            sc = H * cache_len * hd * 2 * 2                         # qk + pv
            return 2 * tokens * proj + tokens * sc
        sc = _chunked_scores(Sq, Skv, window) * B * H * hd * 2 * 2
        return 2 * tokens * proj * bwd + sc * bwd

    def _chunked_scores(sq: int, skv: int, window: int) -> float:
        """score elements computed by the chunked kernel (incl. padding waste;
        no causal/window block skipping — masking only)."""
        if sq == 1:
            return min(window, skv) if window else skv
        if sq * skv <= Q_CHUNK * KV_CHUNK * 4 or sq < Q_CHUNK:
            return sq * skv
        return _pad_to(sq, Q_CHUNK) * _pad_to(skv, KV_CHUNK)

    def mlp_flops() -> float:
        n_mats = 3 if m.gated_mlp else 2
        return 2 * tokens * n_mats * d * ff * bwd

    def moe_flops() -> float:
        """Mirrors models/mlp.py: per-shard groups of min(1024, T_local) tokens,
        capacity ceil(gs·k/E·1.25) floored at 4 — the floor is a real padding
        cost at decode batch sizes (visible as useful_flops_ratio < 1)."""
        mo = m.moe
        ffe = mo.expert_d_ff or ff
        t_local = max(tokens // max(dp, 1), 1)
        gs = min(1024, t_local)
        g_local = max(t_local // gs, 1)
        cap = max(int(math.ceil(gs * mo.experts_per_token
                                / mo.num_experts * 1.25)), 4)
        expert_tokens_local = g_local * mo.num_experts * cap   # capacity-padded
        f = 2 * expert_tokens_local * 3 * d * ffe * bwd        # expert FFNs
        f += 2 * t_local * d * mo.num_experts * bwd            # router
        # dispatch + combine einsums: (g,t,e,c) x (g,t,d)
        f += 2 * g_local * gs * mo.num_experts * cap * d * 2 * bwd
        if mo.num_shared_experts:
            f += 2 * t_local * 3 * d * ffe * mo.num_shared_experts * bwd
        return f * dp                                           # back to global

    def rwkv_flops() -> float:
        proj = 5 * d * d + d * (5 * 32) + 64 * d + d * 64
        cm = 2 * d * ff + d * d
        state = 3 * H * hd * hd  # per-token state update + readout
        return 2 * tokens * (proj + cm + state) * bwd

    def rglru_flops() -> float:
        dr = m.recurrent.d_rnn or d
        proj = 2 * d * dr + 2 * dr * dr + dr * d
        return 2 * tokens * proj * bwd + tokens * dr * 8

    # ---- assemble over layers ---------------------------------------------
    att_f = mlp_f = rec_f = 0.0
    if m.recurrent.kind == "rwkv6":
        rec_f = L * rwkv_flops()
    elif m.family == "hybrid":
        pat = m.recurrent.block_pattern
        for i in range(L):
            if pat[i % len(pat)] == "recurrent":
                rec_f += rglru_flops()
            else:
                att_f += attn_flops(window_of("local"))
            mlp_f += mlp_flops()
    else:
        att_f = L * attn_flops(m.attention_window)
        mlp_f = L * (moe_flops() if m.moe.enabled else mlp_flops())
        if m.is_encoder_decoder:
            Se = m.encoder_seq_len
            enc_tokens = B * Se
            per_enc_layer = (2 * enc_tokens * (d * H * hd * 2 + 2 * d * KV * hd)
                             + 2 * 2 * B * H * Se * Se * hd
                             + 2 * enc_tokens * 2 * d * ff)
            # decode re-uses the prefilled encoder states (cross-KV cached)
            flops["encoder"] = (0.0 if is_decode
                                else m.n_encoder_layers * per_enc_layer * bwd)
            cross_scores = 2 * 2 * B * H * Sq * Se * hd
            flops["cross_attn"] = L * (2 * tokens * (d * H * hd + H * hd * d)
                                       + cross_scores) * bwd

    head_f = 2 * tokens * d * V * bwd
    if shape.kind == "prefill":
        head_f = 2 * B * d * V  # last position only
    if m.mtp_depth and is_train:
        head_f *= 2
        mlp_f *= (L + 1) / L

    local_iters = config.fl.local_iters if (is_train and step_kind.endswith("fl_round")) else 1
    # FL round: same total tokens split across I iterations -> flops unchanged,
    # but the delta quantize/dequant adds O(params) elementwise work (negligible).

    flops["attention"] = att_f / (attn_par * dp)
    flops["mlp"] = mlp_f / (ff_par * dp)
    flops["recurrent"] = rec_f / dp / (model_par if d % model_par == 0 and rec_f else 1)
    flops["head"] = head_f / (vocab_par * dp)
    if "encoder" in flops:
        flops["encoder"] = flops["encoder"] / dp
        flops["cross_attn"] = flops["cross_attn"] / dp

    # ---- bytes ---------------------------------------------------------------
    params_global = m.param_count() * dtype_b
    fsdp_par = ms.get("data", 1) if config.train.fsdp else 1
    # param STORAGE sharding: zero/decode_2d keep model-sharded params even
    # though compute is batch-parallel; plain dp_over_model replicates them
    mp_params = model_par_orig if (zero or decode_2d) else model_par
    param_dev = params_global / (mp_params * fsdp_par)
    # fwd reads params once; bwd reads again + writes grads/update
    param_traffic = param_dev * (3.0 if is_train else 1.0)
    if is_train and step_kind.endswith("fl_round"):
        param_traffic *= local_iters          # each local iter re-reads/writes
        param_traffic += param_dev * 3        # delta build + quantize + apply

    tokens_dev = tokens / dp
    act_depth = L * (6 if is_train else 3)    # rough residual-stream traffic
    act_bytes = tokens_dev * d * dtype_b * act_depth

    cache_bytes = 0.0
    if is_decode:
        C = min(m.attention_window or S, S)
        if m.recurrent.kind == "rwkv6":
            cache_dev = L * B * H * hd * hd * 4 / dp
        elif m.mla.enabled:
            a = m.mla
            cache_dev = L * B * S * (a.kv_lora_rank + a.qk_rope_head_dim) * dtype_b / dp
        elif m.family == "hybrid":
            n_att = sum(1 for i in range(L)
                        if m.recurrent.block_pattern[i % len(m.recurrent.block_pattern)] != "recurrent")
            cache_dev = (n_att * B * min(m.local_window, S) * KV * hd * 2 * dtype_b
                         + (L - n_att) * B * (m.recurrent.d_rnn or d) * 4) / dp
        else:
            cache_dev = L * B * C * KV * hd * 2 * dtype_b / dp
            if cache_seq_model:
                cache_dev /= model_par_orig       # seq dim sharded over model
            elif KV % model_par == 0 and model_par > 1:
                cache_dev /= model_par
            # else: replicated across model — each device holds a full copy
        cache_bytes = cache_dev * 2  # read + write(update slot) upper bound
    if shape.kind == "prefill":
        C = min(m.attention_window or S, S)
        cache_bytes = L * B * C * KV * hd * 2 * dtype_b / dp  # cache write-out

    # ---- collectives -----------------------------------------------------------
    axes = [a for a in config.fl.cohort_axes if a in ms] if is_train else []
    if is_train:
        if step_kind.endswith("fl_round") and axes:
            # single source of truth for the per-mode wire width, including
            # "auto" resolution and the degenerate fallbacks (unquantized
            # uplink -> f32 psum, lane>32 -> int container) that the
            # runtime collectives apply; rsag's phases are itemized so the
            # scatter (growing lanes) and gather (final lane) legs stay
            # separately visible in the roofline breakdown
            axis_sizes = tuple(ms[a] for a in axes)
            shards = 1
            for s in axis_sizes:
                shards *= s
            eff = agg_wire.effective_wire_format(collective_mode,
                                                 config.quant, shards,
                                                 axis_sizes=axis_sizes)
            phases = agg_wire.wire_phase_bits_per_param(collective_mode,
                                                        config.quant,
                                                        axis_sizes)
            # psum modes: an all-reduce moves each param ~twice (reduce +
            # broadcast); the ring/rsag phases already charge every hop
            # explicitly.
            allreduce_factor = 1.0 if eff in ("ring", "rsag") else 2.0
            for phase, bits in phases.items():
                key = "fl_allreduce" if phase == "psum" else f"fl_{phase}"
                coll[key] = (allreduce_factor * m.param_count() * bits / 8.0
                             / (model_par * fsdp_par))
        else:
            # grads carry the param dtype (bf16) under GSPMD
            coll["grad_allreduce"] = 2.0 * params_global / (model_par * fsdp_par)
        if dp_over_model and not zero:
            # within-cohort DP: grads all-reduce over `model` each local iter
            coll["cohort_dp_allreduce"] = (local_iters * 2.0 * params_global
                                           / fsdp_par)
        if zero:
            # ZeRO-within-cohort: all-gather params (fwd+bwd) + reduce-scatter
            # grads each local iter ~ 3x params on the wire per iter
            coll["cohort_zero_collectives"] = (local_iters * 3.0
                                               * params_global / fsdp_par)
        if config.train.fsdp:
            coll["fsdp_allgather"] = params_global / (model_par * fsdp_par) * (2 if is_train else 1)
    if decode_2d:
        # per-layer activation reshard between batch-parallel attention and
        # TP projections: tiny (B/dp x d per layer)
        coll["decode_act_reshard"] = 2 * L * tokens_dev * d * dtype_b
    if cache_seq_model:
        # per-layer softmax-stat + partial-output reduce over `model`
        coll["decode_seq_softmax_reduce"] = (
            2 * L * tokens_dev * H * (hd + 2) * 4)
    # TP activation all-reduces: 2/layer (attn-out + mlp-out) fwd, x2 for bwd.
    # The I local FL iters each touch tokens/I, so I cancels out.
    if model_par > 1:
        tp_reduces = L * 2 * (2 if is_train else 1)
        coll["tp_allreduce"] = tp_reduces * tokens_dev * d * dtype_b * 2.0
    if m.moe.enabled and model_par > 1:
        # dispatch/combine all-to-all of expert inputs/outputs
        mo = m.moe
        cap_tokens = tokens_dev * mo.experts_per_token * 1.25
        coll["moe_alltoall"] = (2 if not is_train else 4) * cap_tokens * d * dtype_b

    return CostBreakdown(flops=flops, param_bytes=param_traffic,
                         act_bytes=act_bytes, cache_bytes=cache_bytes,
                         collective_bytes=coll)
