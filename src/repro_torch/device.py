"""Device and generator resolution shared by every entry point."""
from __future__ import annotations

import time
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; never fall back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def make_generator(seed_or_gen: Union[int, torch.Generator],
                   device: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: seeded from an int, or checked."""
    if isinstance(seed_or_gen, torch.Generator):
        if seed_or_gen.device.type != device.type:
            raise ValueError(f"generator lives on {seed_or_gen.device}, "
                             f"tensors on {device}")
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def seconds_since(t0: float, device: torch.device) -> float:
    """Host seconds since ``t0`` (``time.perf_counter``), once the device
    has finished its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0
