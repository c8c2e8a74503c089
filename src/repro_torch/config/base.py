"""Typed config dataclasses — the port's own copy of ``repro.config.base``.
Field names, defaults and units are the reference's, so one config means
the same in both packages.  ``apply_overrides`` patches any dotted field
from the command line (``model.n_layers=2 quant.bits=8``), as the
reference's launchers do.

The model and train sections are whole, so that every override the
reference's trainer takes resolves here too; some of their fields are inert
in the port:

- ``ModelConfig`` has every field and the whole ``param_count`` and
  ``active_param_count`` (their MoE, MLA, recurrent, hybrid and encoder
  branches included), and the MoE, MLA and recurrent sub-configs; the
  port builds every family of the reference's zoo.
- ``TrainConfig.learning_rate``, ``warmup_steps``, ``weight_decay`` and
  ``optimizer`` (the optimizer's fields) are read by neither trainer: both
  step plain SGD at ``fl.learning_rate``.  ``optim`` ports the reference's
  optimizers and schedules that these fields name, but no trainer calls
  them, in either package, so the fields stay inert.  ``fsdp``,
  ``dp_over_model``, ``zero_over_model`` and ``decode_batch_2d`` choose
  the reference's sharding (``sharding.rules``, ``launch.inputs``), which
  changes no number.  The distributed round places parameters by the
  "model" entries of those rules (``sharding.placement``); it stores
  ``fsdp``'s "data" entries whole between rounds, and raises for
  ``zero_over_model`` at a model axis above 1 (ROADMAP A.6).

The other sections hold the fields the ported slices read; a field comes
back with the slice that first reads it.

``QuantConfig.use_pallas`` is not ported: on a CUDA tensor the port always
runs its hand-written kernel, and on a CPU tensor the kernel's plain
version, so there is nothing to switch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Tuple

# The distributed collective wire formats ``make_fl_round`` accepts ("auto"
# resolves to a concrete mode when the round is built).
COLLECTIVE_CHOICES = ("paper", "int", "packed", "ring", "rsag", "auto")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int = 0            # 0 => dense MLP
    experts_per_token: int = 0      # top-k
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    expert_d_ff: int = 0            # per-expert hidden size
    router_aux_loss_coef: float = 0.001
    router_noise: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V3)."""
    enabled: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class RecurrentConfig:
    """Recurrent (SSM / linear-RNN) block configuration."""
    kind: str = "none"              # none | rwkv6 | rglru
    d_rnn: int = 0                  # lru width (rglru); rwkv uses d_model
    conv1d_width: int = 4           # temporal conv in recurrent block (rglru)
    # For hybrid archs: pattern of block kinds, e.g. ("recurrent","recurrent","attention")
    block_pattern: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0               # 0 => d_model // n_heads
    max_seq_len: int = 8192
    # attention
    attention_window: int = 0       # 0 => full causal; >0 => sliding window
    local_window: int = 2048        # window used by "local" blocks in hybrids
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # norms / activations
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm | nonparametric_ln
    activation: str = "silu"        # silu | gelu | relu2 (squared relu)
    gated_mlp: bool = True          # llama-style gate (3 mats) vs plain (2 mats)
    tie_embeddings: bool = False
    # sub-configs
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    recurrent: RecurrentConfig = field(default_factory=RecurrentConfig)
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500     # whisper: 30s audio -> 1500 frames
    # multi-token prediction (deepseek)
    mtp_depth: int = 0
    # vlm / audio frontends are stubs: inputs arrive as embeddings/token ids
    frontend: str = "none"          # none | vq_tokens | audio_frames
    dtype: str = "bfloat16"
    # citation for the assigned config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head). Approximate for
        exotic blocks but exact enough for 6ND roofline accounting."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d
        head = 0 if self.tie_embeddings else v * d
        per_layer = 0
        if self.recurrent.kind == "rwkv6":
            # time-mix: r,k,v,g,o projections + decay/ddlerp params; channel-mix ~ 2*d*ff
            per_layer = 5 * d * d + 2 * d * ff + 8 * d
        elif self.family == "hybrid":
            # averaged over block pattern below; handled per block kind
            pass
        if self.family == "hybrid" and self.recurrent.block_pattern:
            total = 0
            pat = self.recurrent.block_pattern
            d_rnn = self.recurrent.d_rnn or d
            for i in range(self.n_layers):
                kind = pat[i % len(pat)]
                if kind == "recurrent":
                    blk = 2 * d * d_rnn + 2 * d_rnn  # in/out proj + gates approx
                    blk += 3 * d * ff                # gated mlp
                else:
                    q = d * self.n_heads * hd
                    kv = 2 * d * self.n_kv_heads * hd
                    o = self.n_heads * hd * d
                    blk = q + kv + o + 3 * d * ff
                total += blk
            return emb + head + total
        if per_layer == 0:
            if self.mla.enabled:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.qk_rope_head_dim + m.qk_nope_head_dim)
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                o = self.n_heads * m.v_head_dim * d
                attn = q + kv + o
            else:
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                attn = q + kv + o
            if self.moe.enabled:
                ff_e = self.moe.expert_d_ff or ff
                mlp = (self.moe.num_experts + self.moe.num_shared_experts) * 3 * d * ff_e
                mlp += d * self.moe.num_experts  # router
            else:
                n_mats = 3 if self.gated_mlp else 2
                mlp = n_mats * d * ff
            per_layer = attn + mlp
        enc = 0
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            enc = self.n_encoder_layers * (q + kv + o + 2 * d * ff)
            per_layer += q + kv + o  # cross attention in each decoder layer
        return emb + head + self.n_layers * per_layer + enc

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.moe.enabled:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        ff_e = self.moe.expert_d_ff or ff
        total = self.param_count()
        all_experts = self.moe.num_experts * 3 * d * ff_e
        active_experts = self.moe.experts_per_token * 3 * d * ff_e
        return total - self.n_layers * all_experts + self.n_layers * active_experts


@dataclass(frozen=True)
class QuantConfig:
    """Stochastic fixed-point quantization (paper §II-A/B).

    ``bits`` = n total (1 sign/integer bit + n-1 fractional). ``bits=0`` disables
    quantization (the paper's "non-quantized FL" baseline).
    """
    bits: int = 8
    clip: float = 1.0               # weights clipped to [-clip, clip]
    stochastic: bool = True         # stochastic (unbiased) vs nearest rounding
    quantize_training: bool = True  # quantize weights during local training (QNN)
    quantize_uplink: bool = True    # quantize the transmitted delta
    # what the cohort round puts on the wire (make_fl_round default):
    # "f32" (paper-faithful float sum), "int", "packed", "ring", "rsag",
    # "auto" — see core/aggregation.py
    wire_format: str = "f32"
    # the hop modes' schedule: True fuses the ring's quantize->pack front-end
    # into one quantize_pack_chunk launch; False runs quantize_pack and a
    # repack from zero.  Bit-identical either way.
    pipeline_hops: bool = True

    @property
    def enabled(self) -> bool:
        return self.bits > 0


@dataclass(frozen=True)
class ChannelConfig:
    """Finite-blocklength uplink (paper §II-D2). Defaults = paper §IV."""
    bandwidth_hz: float = 10e6      # B_k
    noise_psd_dbm: float = -100.0   # N0 (dBm, treated as total noise power per paper's scale)
    blocklength: int = 1000         # M symbols
    error_prob: float = 0.01        # q (target packet error probability)
    tx_power_w: float = 0.1         # P_tx
    rayleigh_scale: float = 1.0     # E[|h|^2]

    @property
    def noise_w(self) -> float:
        return 10.0 ** (self.noise_psd_dbm / 10.0) * 1e-3


@dataclass(frozen=True)
class EnergyConfig:
    """Device energy model (paper eq. 7/9, §IV constants)."""
    beta: float = 1e-27             # J/cycle effective switched capacitance
    cycles_per_bit: float = 40.0    # C
    cpu_freq_hz: float = 1e9        # f
    compute_capacity_flops: float = 3.7e12  # C_comp
    macs_per_iteration: float = 4_241_152.0  # paper's QNN; overridden per model


@dataclass(frozen=True)
class ConvergenceConfig:
    """FedAvg-with-drops convergence constants (paper §III / §IV)."""
    L: float = 0.097
    mu: float = 1.0
    m: float = 0.01                 # quantization-variance constant
    H2: float = 0.25                # H^2? paper: H=0.25 used as H^2 bound on sq. norm
    sigma_k2: float = 0.001
    gamma_noniid: float = 0.6       # Γ
    delta1: float = 0.01            # Δ_1
    target_eps: float = 0.1


#: cohort selection policies of the population layer (``population``):
#: ``lyapunov`` ranks by the drift-plus-penalty score of ``population.power``
SELECTION_POLICIES = ("uniform", "rate_aware", "energy_aware", "round_robin",
                      "lyapunov")

#: per-device uplink power policies (``population.power``)
POWER_POLICIES = ("fixed", "channel_inversion", "fbl_target", "lyapunov")


@dataclass(frozen=True)
class PowerConfig:
    """Per-device adaptive uplink transmit power (``population.power``).

      fixed              every device transmits at ``p_fixed`` (0 → the
                         ``ChannelConfig.tx_power_w`` scalar); seed it from
                         the CMA-ES optimum with
                         ``population.power.calibrate_fixed_power``.
      channel_inversion  the power that hits ``target_snr_db`` at the
                         device's current gain, clipped to [p_min, p_max].
      fbl_target         the minimum power whose predicted FBL rate (at the
                         configured ``error_prob``) completes the d·n uplink
                         inside ``tau_limit_s``, clipped to [p_min, p_max];
                         a clip at p_max marks predicted outage.
      lyapunov           each device picks the grid power maximizing
                         V·rate − drift·energy, drift growing as its battery
                         drains (V = lyapunov_v).
    """
    policy: str = "fixed"           # one of POWER_POLICIES
    p_fixed: float = 0.0            # fixed-policy power (0 => channel.tx_power_w)
    p_min: float = 1e-3             # lowest assignable tx power (W)
    p_max: float = 2.0              # highest assignable (the CMA-ES box upper)
    target_snr_db: float = 10.0     # channel_inversion SNR target
    fbl_rate_margin: float = 1.05   # fbl_target headroom over the deadline rate
    lyapunov_v: float = 0.2         # drift-plus-penalty utility weight V


@dataclass(frozen=True)
class FleetConfig:
    """Heterogeneous device population (``population``).

    ``size`` = 0 disables the fleet: the simulator and the cohort round run
    the paper's homogeneous i.i.d. cohort.  With a fleet every device
    carries a pathloss class, an AR(1) correlated fading state, a battery
    (J) debited by the §II-D energy model each round it is selected, and a
    per-round availability draw; cohorts are chosen by a ``selection``
    policy over the whole fleet and packet errors follow each device's FBL
    operating point (outage ⇒ certain drop).
    """
    size: int = 0                   # fleet device count N_f (0 = disabled)
    selection: str = "uniform"      # one of SELECTION_POLICIES
    fading_rho: float = 0.9         # AR(1) coefficient of the complex fading
    pathloss_classes: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.125)
    class_probs: Tuple[float, ...] = ()   # () => uniform over classes
    battery_j: float = 50.0         # mean initial battery energy (J)
    battery_spread: float = 0.5     # uniform ± fraction around battery_j
    availability: float = 0.9       # per-round duty-cycle probability
    error_reweight: bool = False    # opt-in unbiased 1/(1-q) correction
    # energy harvested by every device per round, capped at its initial
    # capacity; ``harvest_class_scale`` scales it per pathloss class
    # (() => 1.0 for every class)
    harvest_j_per_round: float = 0.0
    harvest_class_scale: Tuple[float, ...] = ()
    seed: int = 0                   # fleet init seed (independent of fl.seed)

    @property
    def enabled(self) -> bool:
        return self.size > 0


@dataclass(frozen=True)
class FLConfig:
    """Federated orchestration (paper §II-C / §IV)."""
    num_devices: int = 100          # N
    devices_per_round: int = 10     # K
    local_iters: int = 3            # I
    learning_rate: float = 0.001
    tau_limit_s: float = 1.0        # per-round latency constraint
    error_aware: bool = True        # eq.6 renormalization vs naive eq.5
    # names of the cohort axes of make_fl_round, outermost first
    cohort_axes: tuple = ("pod", "data")
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.0
    optimizer: str = "sgd"          # sgd | adam | adamw  (paper uses plain SGD)
    remat: bool = True              # activation checkpointing over layer scan
    fsdp: bool = False              # shard stacked layer params over data axis
    # beyond-paper (§Perf): use the `model` mesh axis as extra data
    # parallelism inside each client cohort instead of tensor parallelism —
    # for small archs, TP activation all-reduces (∝ tokens·d·L) dwarf the
    # within-cohort grad reduction (∝ params·I). Params replicate over model.
    dp_over_model: bool = False
    # beyond-paper (§Perf): like dp_over_model but params STAY model-sharded
    # (ZeRO-within-cohort): per-layer all-gather inside the local steps; the
    # model axis is pure DP within a cohort so FL semantics are preserved.
    zero_over_model: bool = False
    # beyond-paper (§Perf): shard the DECODE batch over (data, model) — the
    # KV-cache replication fix for GQA archs with kv_heads % model != 0.
    decode_batch_2d: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    channel: ChannelConfig = field(default_factory=ChannelConfig)
    energy: EnergyConfig = field(default_factory=EnergyConfig)
    convergence: ConvergenceConfig = field(default_factory=ConvergenceConfig)
    fl: FLConfig = field(default_factory=FLConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    power: PowerConfig = field(default_factory=PowerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# ---------------------------------------------------------------------------
# Overrides: dotted key=value strings -> nested dataclass replace
# ---------------------------------------------------------------------------

def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        items = [s for s in raw.strip("()[] ").split(",") if s]
        elem = current[0] if current else ""
        return tuple(_coerce(elem, s.strip()) for s in items)
    return raw


def apply_overrides(cfg: Any, overrides: Dict[str, str] | Tuple[str, ...]) -> Any:
    """Apply ``{"model.n_layers": "2"}`` or ("model.n_layers=2", ...) to a config."""
    if not isinstance(overrides, dict):
        pairs = {}
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override must be key=value, got {item!r}")
            k, v = item.split("=", 1)
            pairs[k.strip()] = v.strip()
        overrides = pairs
    for key, raw in overrides.items():
        parts = key.split(".")
        cfg = _replace_path(cfg, parts, raw)
    return cfg


def _replace_path(node: Any, parts, raw: str) -> Any:
    name = parts[0]
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot descend into non-dataclass at {name!r}")
    valid = {f.name for f in fields(node)}
    if name not in valid:
        raise KeyError(f"unknown config field {name!r}; valid: {sorted(valid)}")
    current = getattr(node, name)
    if len(parts) == 1:
        return replace(node, **{name: _coerce(current, raw)})
    return replace(node, **{name: _replace_path(current, parts[1:], raw)})
