"""The token batches of the serving shapes (the batch shapes of the
reference's ``launch/inputs.py``; its partition specs place a batch on a
mesh and mean nothing on one device).

``prefill_shape`` is the (B, S) prompt ``LM.prefill`` takes for an
``InputShape``, ``decode_shape`` the (B, 1) token ``LM.decode_step``
takes; both int32, as the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.shapes import InputShape

TOKEN_DTYPE = torch.int32


def prefill_shape(shape: InputShape) -> Tuple[int, int]:
    return shape.global_batch, shape.seq_len


def decode_shape(shape: InputShape) -> Tuple[int, int]:
    return shape.global_batch, 1


def random_tokens(size: Tuple[int, ...], vocab_size: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Token ids uniform in [0, vocab_size) on the generator's device."""
    return torch.randint(0, vocab_size, size, generator=gen,
                         dtype=TOKEN_DTYPE, device=gen.device)
