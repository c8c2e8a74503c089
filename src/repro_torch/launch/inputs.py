"""The token batches of the serving shapes (the batch shapes of the
reference's ``launch/inputs.py``; its partition specs place a batch on a
mesh and mean nothing on one device).

``prefill_shape`` is the (B, S) prompt ``LM.prefill`` takes for an
``InputShape``, ``decode_shape`` the (B, 1) token ``LM.decode_step``
takes; both int32, as the reference's.  An encoder-decoder's prefill and
training batch also carry ``frames`` (B, encoder_seq_len, d_model) in the
model's dtype (``frames_shape``): whisper's audio frontend is a stub, its
input precomputed frame embeddings.  Chameleon's VQ image codes arrive as
ordinary token ids in the shared vocabulary.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.config.base import Config
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


def frames_shape(config: Config, batch: int) -> Tuple[int, int, int]:
    """The (B, Se, d) frame embeddings of an encoder-decoder's batch."""
    m = config.model
    return batch, m.encoder_seq_len, m.d_model


def random_frames(config: Config, batch: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Standard normal frames (B, Se, d) in float32 on the generator's
    device, as the reference's server draws them (the model casts them to
    its dtype)."""
    return torch.randn(frames_shape(config, batch), generator=gen,
                       device=gen.device)
