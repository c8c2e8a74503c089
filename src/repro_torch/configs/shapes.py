"""The four input shapes of the reference (``repro.configs.shapes``).

``train_4k`` is a training step; ``prefill_32k`` a prefill of the prompt;
``decode_32k`` and ``long_500k`` one new token a sequence against a KV
cache of ``seq_len``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; valid: {sorted(SHAPES)}")
    return SHAPES[name]
