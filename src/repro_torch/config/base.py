"""Typed config dataclasses — the port's own copy of ``repro.config.base``,
trimmed to the fields the ported slices read; a field comes back with the
slice that first reads it.  Field names, defaults and units are the
reference's, so one config means the same in both packages.

``QuantConfig.use_pallas`` is not ported: on a CUDA tensor the port always
runs its hand-written kernel, and on a CPU tensor the kernel's plain
version, so there is nothing to switch.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

# The distributed collective wire formats ``make_fl_round`` accepts ("auto"
# resolves to a concrete mode when the round is built).
COLLECTIVE_CHOICES = ("paper", "int", "packed", "ring", "rsag", "auto")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # only "cnn" is ported so far
    source: str = ""


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
