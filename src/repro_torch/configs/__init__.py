"""Config registry: ``get_config("mnist_cnn")`` returns the module's CONFIG."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import Config

_ARCHS: Dict[str, str] = {
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
}


def get_config(name: str) -> Config:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; valid: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[name]).CONFIG
