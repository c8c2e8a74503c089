"""Input stand-ins and their placement on a mesh (the reference's
``launch/inputs.py``), and the token batches of the serving shapes.

``train_batch_specs``, ``prefill_specs`` and ``decode_specs`` return
(stand-ins, specs) per (config, input shape, mesh): each stand-in a
tensor on the ``meta`` device (its shape and dtype, no storage; a decode
cache is the model's ``init_cache`` there), each spec a tuple with one
entry per dim (``sharding.rules``: None, an axis name or a tuple of
names).  Nothing here allocates.  The cache's leaves are the port's
(``models.transformer``): where the reference keeps the hybrid's states
a layer at a time, the port stacks them over the recurrent layers, and
their specs lead with None for that dim.

``prefill_shape`` is the (B, S) prompt ``LM.prefill`` takes for an
``InputShape``, ``decode_shape`` the (B, 1) token ``LM.decode_step``
takes; both int32, as the reference's.  An encoder-decoder's prefill and
training batch also carry ``frames`` (B, encoder_seq_len, d_model) in the
model's dtype (``frames_shape``): whisper's audio frontend is a stub, its
input precomputed frame embeddings.  Chameleon's VQ image codes arrive as
ordinary token ids in the shared vocabulary.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.config.base import Config
from repro_torch.configs.shapes import InputShape

TOKEN_DTYPE = torch.int32

Mesh = Mapping[str, int]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh)


def _batch_entry(mesh: Mesh, batch: int, *, include_model: bool = False):
    axes = dp_axes(mesh)
    if include_model and "model" in mesh:
        axes = axes + ("model",)
    size = 1
    for a in axes:
        size *= mesh[a]
    if batch % size == 0:
        return axes if len(axes) > 1 else axes[0]
    # try data-only
    if "data" in mesh and batch % mesh["data"] == 0:
        return "data"
    return None


def _div(mesh: Mesh, axis: str, n: int) -> bool:
    return axis in mesh and n % mesh[axis] == 0


# -- batches (train / prefill) ---------------------------------------------------

def train_batch_specs(config: Config, shape: InputShape, mesh: Mesh
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    m = config.model
    B, S = shape.global_batch, shape.seq_len
    b = _batch_entry(mesh, B, include_model=config.train.dp_over_model)
    if m.family == "cnn":
        return ({"images": _meta((B, 28, 28, 1), torch.float32),
                 "labels": _meta((B,), TOKEN_DTYPE)},
                {"images": (b, None, None, None), "labels": (b,)})
    structs = {"tokens": _meta((B, S), TOKEN_DTYPE),
               "labels": _meta((B, S), TOKEN_DTYPE)}
    specs = {"tokens": (b, None), "labels": (b, None)}
    if m.is_encoder_decoder:
        structs["frames"] = _meta(frames_shape(config, B),
                                  getattr(torch, m.dtype))
        specs["frames"] = (b, None, None)
    return structs, specs


def prefill_specs(config: Config, shape: InputShape, mesh: Mesh):
    """((tokens[, frames]), (their specs))."""
    m = config.model
    B, S = shape.global_batch, shape.seq_len
    b = _batch_entry(mesh, B)
    tokens = _meta((B, S), TOKEN_DTYPE)
    if m.is_encoder_decoder:
        frames = _meta(frames_shape(config, B), getattr(torch, m.dtype))
        return (tokens, frames), ((b, None), (b, None, None))
    return (tokens,), ((b, None),)


# -- decode caches ---------------------------------------------------------------

def decode_specs(model, config: Config, shape: InputShape, mesh: Mesh, *,
                 batch_2d: Optional[bool] = None):
    """((cache stand-ins, token stand-in), (cache specs, token spec)).

    ``batch_2d`` (``train.decode_batch_2d`` by default): shard the decode
    batch over (data, model) instead of data only; where the batch does
    not divide data x model, shard the cache's SEQUENCE dim over "model"
    instead.  A batch of 1 (long_500k) shards the cache's sequence dim
    over "data"."""
    m = config.model
    if batch_2d is None:
        batch_2d = config.train.decode_batch_2d
    B, S = shape.global_batch, shape.seq_len
    b = _batch_entry(mesh, B, include_model=batch_2d)
    got_2d = batch_2d and isinstance(b, tuple) and "model" in b
    seq_over_model = batch_2d and not got_2d
    cache = model.init_cache(B, S, device="meta")
    seq_parallel = b is None

    kv_ok = _div(mesh, "model", m.n_kv_heads) and not got_2d and not seq_over_model
    heads_ok = _div(mesh, "model", m.n_heads) and not got_2d

    def model_if(n):
        return "model" if _div(mesh, "model", n) else None

    def seq_entry(size):
        if seq_parallel and _div(mesh, "data", size):
            return "data"
        if seq_over_model and _div(mesh, "model", size):
            return "model"
        return None

    def spec_for(name: str, t: torch.Tensor) -> tuple:
        nd = t.dim()
        if nd == 0 or name == "length":
            return ()
        if name == "kv_pos":                       # (B, C)
            if seq_parallel:
                return (None, "data" if _div(mesh, "data", t.shape[1])
                        else None)
            if seq_over_model and _div(mesh, "model", t.shape[1]):
                return (b, "model")
            return (b, None)
        if name == "S":                            # (L, B, H, hd, hd)
            return (None, b, "model" if heads_ok else None, None, None)
        if name in ("x_tm", "x_cm"):               # (L, B, d)
            return (None, b, model_if(t.shape[2]))
        if name == "h":                            # (L_rec, B, d_rnn)
            return (None, b, model_if(t.shape[2]))
        if name == "conv":                         # (L_rec, B, w-1, d_rnn)
            return (None, b, None, model_if(t.shape[3]))
        if name == "latent":                       # (L, B, C, r + d_rope)
            return (None, b, seq_entry(t.shape[2]), None)
        if nd == 5:                                # k, v, cross: (L,B,C,KV,hd)
            return (None, b, seq_entry(t.shape[2]),
                    "model" if kv_ok else None, None)
        return (None,) * nd

    specs = {k: spec_for(k, v) for k, v in cache.items()}
    return ((cache, _meta((B, 1), TOKEN_DTYPE)), (specs, (b, None)))


# -- serving batches -------------------------------------------------------------


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
