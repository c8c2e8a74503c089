"""Per-client batching pipeline for the FL trainer.

``ClientStore`` keeps the global dataset and the federated partition on the
device.  ``client_batches`` draws the minibatches of a whole round — K
clients × I local steps × B samples, without replacement inside each
minibatch unless the shard is smaller than B — as one gather by index:
the ξ_k minibatch stream of paper eq. 4.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.data.synthetic import digit_dataset, partition_dirichlet, partition_iid
from repro_torch.device import DeviceLike, make_generator, resolve_device


@dataclass
class ClientStore:
    data: Dict[str, torch.Tensor]
    partitions: List[torch.Tensor]
    # (num_clients, max shard) sample indices, padded; (num_clients,) sizes
    _table: torch.Tensor = field(init=False, repr=False)
    _sizes: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        dev = self.device
        sizes = [len(p) for p in self.partitions]
        if min(sizes) == 0:
            raise ValueError("every client needs at least one sample")
        self._table = torch.zeros((len(sizes), max(sizes)), dtype=torch.int64,
                                  device=dev)
        for c, p in enumerate(self.partitions):
            self._table[c, :len(p)] = p.to(dev)
        self._sizes = torch.tensor(sizes, dtype=torch.int64, device=dev)

    @property
    def device(self) -> torch.device:
        return next(iter(self.data.values())).device

    @property
    def num_clients(self) -> int:
        return len(self.partitions)

    def client_sizes(self) -> np.ndarray:
        return np.array([len(p) for p in self.partitions], dtype=np.int64)

    def client_weights(self) -> np.ndarray:
        """α_k = |D_k| / D (paper eq. 6)."""
        sizes = self.client_sizes().astype(np.float64)
        return sizes / sizes.sum()

    def client_batches(self, gen: torch.Generator, clients: torch.Tensor,
                       steps: int, batch_size: int) -> Dict[str, torch.Tensor]:
        """Leaves (K, steps, batch_size, ...) for the K ``clients``."""
        dev = self.device
        K = clients.shape[0]
        sizes = self._sizes[clients]                                  # (K,)
        n_max = self._table.shape[1]
        # with replacement (what a shard smaller than the batch gets)
        r = torch.rand((K, steps, batch_size), generator=gen, device=dev)
        pos = torch.minimum((r * sizes[:, None, None]).long(),
                            sizes[:, None, None] - 1)
        if n_max >= batch_size:
            # without replacement: the batch_size smallest of random keys
            # over each shard's valid slots
            keys = torch.rand((K, steps, n_max), generator=gen, device=dev)
            valid = torch.arange(n_max, device=dev)[None, :] < sizes[:, None]
            keys = keys.masked_fill(~valid[:, None, :], 2.0)
            norep = keys.argsort(dim=-1)[..., :batch_size]
            pos = torch.where((sizes >= batch_size)[:, None, None], norep, pos)
        idx = torch.gather(self._table[clients][:, None, :].expand(K, steps, n_max),
                           2, pos)
        return {k: v[idx] for k, v in self.data.items()}


def make_federated_digits(seed: int = 0, *, num_samples: int = 20000,
                          num_clients: int = 100, iid: bool = True,
                          alpha: float = 0.5,
                          device: DeviceLike = None) -> ClientStore:
    gen = make_generator(seed, resolve_device(device))
    data = digit_dataset(gen, num_samples)
    if iid:
        parts = partition_iid(gen, num_samples, num_clients)
    else:
        parts = partition_dirichlet(gen, data["labels"], num_clients, alpha)
    return ClientStore(data, parts)
