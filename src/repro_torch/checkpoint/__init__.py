"""Checkpoints in the reference's msgpack layout (``checkpoint.ckpt``)."""
from repro_torch.checkpoint.ckpt import (latest_step, param_leaves,
                                         restore_checkpoint, restore_params,
                                         save_checkpoint, save_params)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_params", "restore_params", "param_leaves"]
