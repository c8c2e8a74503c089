"""Federated training orchestration (paper Algorithm 1): the simulator.

``FLSimulator`` is the paper's N=100-device MNIST setting: explicit client
sampling, I local QAT-SGD steps per client (eq. 4, STE fake-quant), uplink
delta quantization, Bernoulli packet drops, error-aware aggregation
(eq. 6), and per-round energy/latency from the §II-D model.

Where the reference ``vmap``s a ``lax.scan`` over clients, the port writes
the batch out: the K selected clients' parameters are one flat (K, D)
float32 tensor (columns in leaf order), so every local step is one
fake-quant launch pair over all K clients, one stacked forward (grouped
convolutions, ``bmm``) and one backward of the summed loss, which gives
each client its own gradient.  The uplink is one quantize and one
dequantize launch over (K, D), and eq. 6 one ``masked_aggregate`` launch.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import convert
from repro_torch.config.base import Config
from repro_torch.core import aggregation as agg
from repro_torch.core import channel as ch
from repro_torch.core import energy as energy_mod
from repro_torch.core import quantization as quant
from repro_torch.device import DeviceLike, make_generator, resolve_device

Batch = Dict[str, torch.Tensor]
GenLike = Union[int, torch.Generator]


@dataclass
class RoundTelemetry:
    loss: float
    accuracy: float
    survivors: int
    energy_j: float
    tau_s: float


class FLSimulator:
    """Algorithm 1 over an explicit client store.

    ``device=None`` means the CUDA device; pass ``device="cpu"`` to run on
    the CPU (the kernels' plain versions).  The round runs in full float32,
    as the reference does: on CUDA the constructor turns TF32 off for cuDNN
    convolutions (``torch.backends.cudnn.allow_tf32``, True by default) and
    for matrix products — a process-wide setting.

    Parameters are the model's flat (D,) float32 vector in leaf order
    (``convert.flatten_params``).  Every random draw comes from the caller's
    ``torch.Generator``; ``_round`` and ``_client_update`` also take the
    noise and packet draws as tensors, so a test can inject the
    reference's own.
    """

    def __init__(self, model, config: Config, client_store, *,
                 device: DeviceLike = None,
                 macs_per_iter: Optional[float] = None):
        self.device = resolve_device(device)
        if client_store.device.type != self.device.type:
            raise ValueError(f"client store on {client_store.device}, "
                             f"simulator on {self.device}")
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model
        self.config = config
        self.store = client_store
        self.shapes = dict(model.param_shapes)
        self.num_params = sum(math.prod(s) for s in self.shapes.values())
        self.alphas = torch.tensor(client_store.client_weights(),
                                   dtype=torch.float32, device=self.device)
        self.macs = macs_per_iter or config.energy.macs_per_iteration
        self._energy: Optional[Tuple[float, float]] = None

    def _uniform(self, gen: Optional[torch.Generator], shape) -> torch.Tensor:
        if gen is None:
            raise ValueError("pass a generator, or the noise tensors")
        return torch.rand(shape, generator=gen, device=self.device)

    # -- the K selected clients: I local steps of quantized SGD (eq. 4) --------

    def _client_update(self, params: torch.Tensor, batches: Batch,
                       gen: Optional[torch.Generator] = None, *,
                       u_train: Optional[torch.Tensor] = None,
                       u_up: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """params (D,); batches leaves (K, I, B, ...); u_train (K, I, D)
        fake-quant noise per step, u_up (K, D) uplink noise.

        Returns the (quantized) deltas (K, D) and each client's mean loss and
        accuracy over its I steps, (K,) each.
        """
        fl, qcfg = self.config.fl, self.config.quant
        K, I = batches["labels"].shape[:2]
        D = params.shape[0]
        fake_quant = qcfg.enabled and qcfg.quantize_training
        p = params.detach().expand(K, D).clone()
        losses, accs = [], []
        for i in range(I):
            p.requires_grad_(True)
            with torch.enable_grad():
                pq = p
                if fake_quant:
                    u = u_train[:, i] if u_train is not None else self._uniform(gen, (K, D))
                    pq = quant.fake_quant_ste(p, u, qcfg.bits, qcfg.clip,
                                              qcfg.stochastic)
                ce, acc = self.model.loss_stacked(
                    convert.unflatten_params(pq, self.shapes),
                    {k: v[:, i] for k, v in batches.items()})
                (grad,) = torch.autograd.grad(ce.sum(), p)
            p = p.detach() - fl.learning_rate * grad
            losses.append(ce.detach())
            accs.append(acc)
        delta = p - params
        if qcfg.enabled and qcfg.quantize_uplink:
            u = u_up if u_up is not None else self._uniform(gen, (K, D))
            delta = quant.quantize(delta, u, qcfg)
        return delta, torch.stack(losses).mean(0), torch.stack(accs).mean(0)

    def _round(self, params: torch.Tensor, batches: Batch,
               client_alphas: torch.Tensor,
               gen: Optional[torch.Generator] = None, *,
               u_train: Optional[torch.Tensor] = None,
               u_up: Optional[torch.Tensor] = None,
               lam: Optional[torch.Tensor] = None):
        """One round on prepared inputs; ``lam`` (K,) are the packet-success
        draws.  Returns (new params, mean loss, mean accuracy, survivors)."""
        K = client_alphas.shape[0]
        deltas, losses, accs = self._client_update(params, batches, gen,
                                                   u_train=u_train, u_up=u_up)
        if lam is None:
            lam = ch.sample_packet_success(gen, (K,),
                                           self.config.channel.error_prob)
        if self.config.fl.error_aware:
            new_params = agg.error_aware_aggregate(params, deltas,
                                                   client_alphas, lam)
        else:
            new_params = agg.naive_aggregate(params, deltas, lam)
        return new_params, losses.mean(), accs.mean(), lam.sum()

    # -- public API -------------------------------------------------------------

    def _round_inputs(self, gen: torch.Generator) -> Tuple[Batch, torch.Tensor]:
        """Client sampling + minibatch gathering: (batches with (K, I, B, ...)
        leaves, client_alphas (K,)) — the inputs of ``_round``."""
        fl = self.config.fl
        clients = torch.randperm(self.store.num_clients, generator=gen,
                                 device=self.device)[:fl.devices_per_round]
        batches = self.store.client_batches(gen, clients, fl.local_iters,
                                            self.config.train.global_batch)
        return batches, self.alphas[clients]

    def run_round(self, params: torch.Tensor, gen: GenLike
                  ) -> Tuple[torch.Tensor, RoundTelemetry]:
        gen = make_generator(gen, self.device)
        batches, client_alphas = self._round_inputs(gen)
        new_params, loss, acc, surv = self._round(params, batches,
                                                  client_alphas, gen)
        e, tau = self.round_energy()
        return new_params, RoundTelemetry(float(loss), float(acc),
                                          int(surv), e, tau)

    def run_rounds(self, params: torch.Tensor, rounds: int, gen: GenLike, *,
                   eval_fn: Optional[Callable[[torch.Tensor], float]] = None,
                   start_round: int = 0) -> Tuple[torch.Tensor, List[dict]]:
        """``rounds`` successive :meth:`run_round` calls.  Each history entry
        carries ``round_s``, the round's host time: reading its loss waits
        for the device, so the time covers the round's device work."""
        gen = make_generator(gen, self.device)
        history = []
        for t in range(rounds):
            t0 = time.perf_counter()
            params, tel = self.run_round(params, gen)
            metric = eval_fn(params) if eval_fn is not None else tel.accuracy
            history.append({"round": start_round + t, "loss": tel.loss,
                            "accuracy": float(metric),
                            "survivors": tel.survivors,
                            "energy_j": tel.energy_j, "tau_s": tel.tau_s,
                            "round_s": time.perf_counter() - t0})
        return params, history

    def round_energy(self) -> Tuple[float, float]:
        """Expected per-round energy (J) and latency (s) at the operating point.

        Seeded from ``fl.seed``, so the same every round: computed on the
        first call and kept."""
        if self._energy is None:
            self._energy = self._expected_energy()
        return self._energy

    def _expected_energy(self) -> Tuple[float, float]:
        cfg = self.config
        bits = cfg.quant.bits if cfg.quant.enabled else 32
        gen = make_generator(cfg.fl.seed, self.device)  # seed-reproducible MC draw
        g2 = ch.sample_rayleigh_gain2(gen, (cfg.fl.num_devices,),
                                      cfg.channel.rayleigh_scale)
        rate = ch.fbl_rate(ch.snr(cfg.channel.tx_power_w, g2, cfg.channel.noise_w),
                           cfg.channel.blocklength, cfg.channel.error_prob)
        rate = torch.clamp(rate, min=1e-9)
        e = energy_mod.expected_total_energy_j(
            cfg.energy, cfg.channel, num_params=self.num_params, bits=bits,
            local_iters=cfg.fl.local_iters, rates_per_device=rate,
            num_devices=cfg.fl.num_devices,
            devices_per_round=cfg.fl.devices_per_round, rounds=1.0)
        tau = energy_mod.round_time_s(
            cfg.energy, cfg.channel, num_params=self.num_params, bits=bits,
            local_iters=cfg.fl.local_iters, macs_per_iter=self.macs,
            rates_per_device=rate, num_devices=cfg.fl.num_devices,
            devices_per_round=cfg.fl.devices_per_round)
        return float(e), float(tau)

    def train(self, params: torch.Tensor, rounds: int, gen: GenLike, *,
              target_accuracy: float = 0.0,
              eval_fn: Optional[Callable[[torch.Tensor], float]] = None,
              log_every: int = 0) -> Tuple[torch.Tensor, List[dict]]:
        """Run rounds until ``rounds`` or the target accuracy; returns
        (params, history).  ``log_every`` prints every that many rounds."""
        gen = make_generator(gen, self.device)
        history: List[dict] = []
        for t in range(rounds):
            params, hist = self.run_rounds(params, 1, gen, eval_fn=eval_fn,
                                           start_round=t)
            h = hist[0]
            history.append(h)
            if log_every and (t % log_every == 0 or t == rounds - 1):
                print(f"round {t:4d}  loss {h['loss']:.4f}  acc "
                      f"{h['accuracy']:.3f}  survivors {h['survivors']}  "
                      f"energy {h['energy_j']:.3f} J  tau {h['tau_s']*1e3:.1f} ms")
            if target_accuracy and h["accuracy"] >= target_accuracy:
                break
        return params, history
