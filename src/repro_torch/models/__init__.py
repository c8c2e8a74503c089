"""Model factory: ``build_model(config)`` returns the family's model.

The paper's QNN (family ``cnn``), the encoder-decoder (whisper-base,
family ``audio``, :class:`WhisperModel`) and the decoder-only LM of every
other family: ``dense`` (olmo-1b, qwen2.5-14b, yi-9b, nemotron-4-340b),
``moe`` (granite-moe-1b-a400m; deepseek-v3-671b with MLA, a shared expert
and multi-token prediction), ``ssm`` (rwkv6-7b), ``hybrid``
(recurrentgemma-2b) and ``vlm`` (chameleon-34b, whose VQ image codes
arrive as token ids).  Every model exposes ``param_shapes`` (leaf shapes
in leaf order; the LM's and whisper's a ``convert.Layout``, which also
holds each leaf's dtype), ``dtype``, ``init``, ``loss`` for one model and
``loss_stacked`` for several stacked on a leading dimension, and
``quantizes_training``: whether its local steps run the STE fake-quant.
"""
from __future__ import annotations

from repro_torch.config.base import Config
from repro_torch.configs import PORTED_FAMILIES
from repro_torch.models.cnn import CNNModel
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import WhisperModel


def build_model(config: Config):
    fam = config.model.family
    if fam not in PORTED_FAMILIES:
        raise ValueError(f"{config.model.name}: unknown family {fam!r}; "
                         f"valid: {PORTED_FAMILIES}")
    if fam == "cnn":
        return CNNModel(config)
    if config.model.is_encoder_decoder:
        return WhisperModel(config)
    return LM(config)


__all__ = ["build_model", "CNNModel", "LM", "WhisperModel"]
