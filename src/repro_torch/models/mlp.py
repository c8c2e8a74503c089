"""The dense MLP block, gated (three matrices) or plain (two).  The
mixture-of-experts block comes with the rest of the zoo (ROADMAP A13).

Weights are (d, ff) matrices for one model or (C, d, ff) for C stacked
cohorts (``common.linear``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import common


def mlp_param_shapes(cfg: ModelConfig, d_ff: int = 0
                     ) -> Dict[str, Tuple[int, ...]]:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    shapes = {"w_up": (d, ff), "w_down": (ff, d)}
    if cfg.gated_mlp:
        shapes["w_gate"] = (d, ff)
    return shapes


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, *, d_ff: int = 0,
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, torch.Tensor]:
    return {name: common.dense_init(gen, shape, dtype=dtype)
            for name, shape in mlp_param_shapes(cfg, d_ff).items()}


def mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
        cfg: ModelConfig) -> torch.Tensor:
    act = common.activation_fn(cfg.activation)
    up = common.linear(x, params["w_up"])
    if cfg.gated_mlp:
        up = act(common.linear(x, params["w_gate"])) * up
    else:
        up = act(up)
    return common.linear(up, params["w_down"])
