"""Synthetic datasets: procedural MNIST-like digits and a Markov-ish token
stream for the language models.

MNIST is not available offline; ``digit_dataset`` draws 28x28 images whose
class-conditional structure (a smoothed random template per class + noise +
random shifts) is learnable by the paper's QNN while remaining non-trivial.
The federated partitioner supports IID and Dirichlet non-IID splits (the
paper's Γ = degree of non-IID-ness).  Every draw comes from the caller's
``torch.Generator`` and lands on that generator's device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def digit_templates(gen: torch.Generator, num_classes: int = 10,
                    size: int = 28) -> torch.Tensor:
    """One smoothed random template per class, unit-normalized."""
    t = torch.randn((num_classes, size, size), generator=gen, device=gen.device)
    # cheap smoothing: 2 passes of 3x3 box filter via rolls
    for _ in range(2):
        t = sum(torch.roll(t, (i, j), dims=(1, 2))
                for i in (-1, 0, 1) for j in (-1, 0, 1)) / 9.0
    t = t - t.mean(dim=(1, 2), keepdim=True)
    return t / (t.std(dim=(1, 2), keepdim=True, correction=0) + 1e-6)


def digit_dataset(gen: torch.Generator, num_samples: int, *,
                  num_classes: int = 10, size: int = 28,
                  noise: float = 0.6) -> Dict[str, torch.Tensor]:
    """Returns {"images": (N, 28, 28, 1) f32, "labels": (N,) int64}."""
    dev = gen.device
    templates = digit_templates(gen, num_classes, size)
    labels = torch.randint(0, num_classes, (num_samples,), generator=gen,
                           device=dev)
    # random +-2px shifts for intra-class variation: out[i] = in[(i - s) % size]
    shifts = torch.randint(-2, 3, (num_samples, 2), generator=gen, device=dev)
    ar = torch.arange(size, device=dev)
    rows = (ar[None, :] - shifts[:, :1]) % size
    cols = (ar[None, :] - shifts[:, 1:]) % size
    imgs = templates[labels[:, None, None], rows[:, :, None], cols[:, None, :]]
    imgs = imgs + noise * torch.randn(imgs.shape, generator=gen, device=dev)
    return {"images": imgs[..., None].float(), "labels": labels}


def partition_iid(gen: torch.Generator, num_samples: int,
                  num_clients: int) -> List[torch.Tensor]:
    perm = torch.randperm(num_samples, generator=gen, device=gen.device)
    return [s.sort().values for s in torch.tensor_split(perm, num_clients)]


def partition_dirichlet(gen: torch.Generator, labels: torch.Tensor,
                        num_clients: int, alpha: float = 0.5) -> List[torch.Tensor]:
    """Non-IID label-skew partition (Dirichlet over clients per class)."""
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=gen.device))
    rng = np.random.default_rng(seed)
    labels = labels.cpu().numpy()
    num_classes = int(labels.max()) + 1
    idx_per_client: List[List[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for client, part in enumerate(np.split(idx, cuts)):
            idx_per_client[client].extend(part.tolist())
    return [torch.tensor(sorted(ix), dtype=torch.int64, device=gen.device)
            for ix in idx_per_client]


def token_batch(gen: torch.Generator, batch: int, seq_len: int,
                vocab: int) -> Dict[str, torch.Tensor]:
    """Markov-ish synthetic token stream: next token depends on current one.

    Returns {"tokens", "labels"}, (batch, seq_len) int32 each on the
    generator's device; the labels are the tokens shifted left by one
    (the last wraps around), as the reference's ``token_batch``."""
    dev = gen.device
    base = torch.randint(0, vocab, (batch, seq_len), generator=gen, device=dev)
    shifted = (base * 31 + 7) % vocab   # deterministic successor structure
    mix = torch.rand((batch, seq_len), generator=gen, device=dev) < 0.5
    tokens = torch.where(mix, base, shifted).to(torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
