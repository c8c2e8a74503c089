"""A small optimizer library on dicts of tensors (the port of
``repro.optim.optimizers``).

An ``Optimizer`` is an (init, update) pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params``, ``grads`` and ``updates`` are dicts of tensors (nested dicts
allowed) in the parameters' dtype; the state (momenta, moments) is float32,
its step a 0-dim int32 tensor, and a schedule maps that step to a 0-dim
float32 learning rate.  The reference runs these eagerly, one rounding an
operation, and so do these: nothing is fused.

The paper trains with plain SGD (eq. 3); neither trainer, the reference's
or the port's, calls an optimizer here, so ``train.optimizer`` stays
inert.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

import torch

Tree = Dict[str, Any]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of dicts of tensors of one structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]


def _to_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: _f32(lr, step)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` with u cast to p's dtype first, as the reference's."""
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def _step0(params: Tree) -> torch.Tensor:
    leaf = next(iter(_leaves(params)))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _zeros32(params: Tree) -> Tree:
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's: taken
    in float64 and rounded once (53 >= 2·24 + 2 bits, so the two roundings
    give the correct one).  PyTorch's vectorised float32 ``sqrt`` on the CPU
    is off by an ulp at about 0.6 % of inputs."""
    return torch.sqrt(x.double()).float()


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine taken in float64 and rounded once: within an ulp of
    the reference's (neither XLA's float32 ``cos`` nor PyTorch's is
    correctly rounded; this one is nearer XLA's)."""
    return torch.cos(x.double()).float()


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params: Tree) -> Tree:
        state = {"step": _step0(params)}
        if momentum:
            state["mu"] = _zeros32(params)
        return state

    def update(grads: Tree, state: Tree, params: Tree = None):
        step = state["step"]
        lr_t = sched(step)
        if momentum:
            mu = _map(lambda m, g: momentum * m + g.to(torch.float32),
                      state["mu"], grads)
            updates = _map(lambda m: -lr_t * m, mu)
            return updates, {"step": step + 1, "mu": mu}
        updates = _map(lambda g: -lr_t * g.to(torch.float32), grads)
        return updates, {"step": step + 1}

    return Optimizer(init, update)


def adam(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _to_schedule(lr)

    def init(params: Tree) -> Tree:
        return {"step": _step0(params), "m": _zeros32(params),
                "v": _zeros32(params)}

    def update(grads: Tree, state: Tree, params: Tree = None):
        step = state["step"] + 1
        lr_t = sched(step)
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2)
                 * torch.square(g.to(torch.float32)), state["v"], grads)
        s = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, s), s)
        bc2 = 1 - torch.pow(_f32(b2, s), s)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (_sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        updates = _map(upd, m, v, params if params is not None else m)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], weight_decay: float = 0.01,
          **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def linear_warmup(base_lr: float, warmup_steps: int) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(step.to(torch.float32) / max(warmup_steps, 1),
                           max=1.0)
        return base_lr * frac
    return sched


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + _cos(math.pi * prog))
        return base_lr * warm * cos
    return sched


def make_optimizer(name: str, lr: Union[float, Schedule], **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, momentum=kw.get("momentum", 0.0))
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=kw.get("weight_decay", 0.01))
    raise ValueError(name)
