"""Model factory: ``build_model(config)`` returns the family's model.

Only the paper's QNN (family ``cnn``) is ported so far; the LM zoo of the
reference waits for a later slice.
"""
from __future__ import annotations

from repro_torch.config.base import Config
from repro_torch.models.cnn import CNNModel


def build_model(config: Config):
    fam = config.model.family
    if fam == "cnn":
        return CNNModel(config)
    raise NotImplementedError(f"model family {fam!r} is not ported yet")


__all__ = ["build_model", "CNNModel"]
