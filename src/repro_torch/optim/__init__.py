"""Optimizers on dicts of tensors (``optim.optimizers``)."""
from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          apply_updates, cosine_schedule,
                                          linear_warmup, make_optimizer, sgd)

__all__ = ["Optimizer", "apply_updates", "sgd", "adam", "adamw",
           "cosine_schedule", "linear_warmup", "make_optimizer"]
