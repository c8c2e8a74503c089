"""Model factory: ``build_model(config)`` returns the family's model.

The paper's QNN (family ``cnn``) and the decoder-only LM of families
``dense`` (olmo-1b, qwen2.5-14b, yi-9b, nemotron-4-340b), ``moe``
(granite-moe-1b-a400m), ``ssm`` (rwkv6-7b) and ``hybrid``
(recurrentgemma-2b) are ported; the rest of the reference's zoo raises
(ROADMAP A13).  Every model exposes ``param_shapes`` (leaf shapes in leaf
order; the LM's is a ``convert.Layout``, which also holds each leaf's
dtype), ``dtype``, ``init``, ``loss`` for one model and ``loss_stacked``
for several stacked on a leading dimension, and ``quantizes_training``:
whether its local steps run the STE fake-quant.
"""
from __future__ import annotations

from repro_torch.config.base import Config
from repro_torch.configs import check_ported
from repro_torch.models.cnn import CNNModel
from repro_torch.models.transformer import LM


def build_model(config: Config):
    check_ported(config)
    if config.model.family == "cnn":
        return CNNModel(config)
    return LM(config)


__all__ = ["build_model", "CNNModel", "LM"]
