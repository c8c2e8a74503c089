"""Roofline constants of one NVIDIA H100 and the derivation of its terms.

Constants from NVIDIA's H100 Tensor Core GPU datasheet, the H100 SXM5
80 GB part (dense rates, without sparsity), at its 700 W power limit:
989.4 TFLOP/s bfloat16 on the tensor cores, 3.35 TB/s of HBM3, and
NVLink 4 at 900 GB/s in all, 450 GB/s a direction.  A card set below
700 W runs slower under load, so a share against these peaks stands
beside the card's power limit.

``analytic_costs`` (``utils.flops``) gives a step's per-device operations
and bytes; each term is their least time in seconds on one card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_FLOPS_BF16 = 989.4e12  # per card
HBM_BW = 3.35e12            # bytes/s per card
NVLINK_BW = 450e9           # bytes/s per card, one direction


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    hlo_flops_global: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        if self.hlo_flops_global <= 0:
            return 0.0
        return self.model_flops_global / self.hlo_flops_global

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def derive_terms(*, flops_per_device: float, bytes_per_device: float,
                 collective_bytes_per_device: float, num_devices: int,
                 model_flops_global: float) -> RooflineTerms:
    """``hlo_flops_global`` keeps the reference's name: the operations the
    step computes on all devices, padding and masked work included."""
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS_BF16,
        memory_s=bytes_per_device / HBM_BW,
        collective_s=collective_bytes_per_device / NVLINK_BW,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops_global=model_flops_global,
        hlo_flops_global=flops_per_device * num_devices,
    )


def model_flops(config, shape) -> float:
    """6·N_active·D (train) / 2·N_active·D (inference): the useful flops."""
    n_active = config.model.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
