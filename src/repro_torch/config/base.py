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
class FLConfig:
    """Federated orchestration (paper §II-C / §IV)."""
    num_devices: int = 100          # N
    devices_per_round: int = 10     # K
    local_iters: int = 3            # I
    learning_rate: float = 0.001
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
    fl: FLConfig = field(default_factory=FLConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
