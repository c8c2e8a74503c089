"""Federated training orchestration (paper Algorithm 1).

Two runtimes share the same local steps (:func:`local_sgd`):

* ``FLSimulator`` is the paper's N=100-device MNIST setting: explicit
  client sampling, I local QAT-SGD steps per client (eq. 4, STE
  fake-quant), uplink delta quantization, Bernoulli packet drops,
  error-aware aggregation (eq. 6), and per-round energy/latency from the
  §II-D model.  The uplink is one quantize and one dequantize launch over
  (K, D), and eq. 6 one ``masked_aggregate`` launch.

* ``make_fl_round`` is the cohort round: C = Π axis_sizes client cohorts,
  each taking I local steps on its slice of the global batch, surviving
  with probability 1-q, and aggregating through a selectable wire format
  (``aggregation.aggregate``: paper, int, packed, ring, rsag, auto).
  The reference runs one cohort per mesh shard; ``make_fl_round`` runs
  the C cohorts stacked on one device, the cohort the leading dimension
  of every tensor, row-major over the cohort axes.

* ``make_dist_fl_round`` is the same round with one cohort a process, as
  the reference's ``shard_map``: each rank of a ``core.comm.Comm`` takes
  its cohort's rows of the batch, steps C = 1 stacked, and uplinks
  through real collectives (``aggregation.aggregate_rank``).  The ranks
  that differ only on the "model" axis hold their cohort's model split as
  ``sharding.rules`` places it (``sharding.placement``): each its blocks
  of the sharded leaves and the replicated leaves whole, the dense
  decoders' forward tensor-parallel over the model group, as the
  reference's GSPMD runs its round body over "model"; where the rules
  shard no leaf (the QNN) they are replicas.

Both runtimes accept a **fleet** (``config.fleet.size > 0``): the device
population of ``population`` — per-device pathloss classes, AR(1)
correlated fading, batteries debited by the §II-D energy model,
availability, cohort selection, FBL-tied packet errors and a per-device
uplink power policy.  ``population.fleet.round_update`` advances it once a
round on the fleet's device with no host round-trip; the simulator keeps
the ``FleetState`` on ``fleet_state`` across calls, and the cohort round
threads it through its signature.  The battery is priced at the
wire-independent d·n payload, so the fleet trajectory, and through it the
model, is identical under every wire format.

Where the reference ``vmap``s a ``lax.scan`` over clients, the port writes
the batch out: the clients' (or cohorts') parameters are flat (K, D)
tensors in the model's layout (``convert.Layout``: one tensor of the
model's dtype, columns in leaf order, where every leaf has that dtype; a
(K, n) buffer per dtype where the reference keeps some leaves in float32),
so every local step is one stacked forward (the QNN's grouped convolutions
and ``bmm``, the LM's batched products), one backward of the summed loss,
which gives each its own gradient, and for the QNN one fake-quant launch
pair over all K.  The uplink's wire vector is one float32 (K, D) in leaf
order whatever the layout.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch import convert
from repro_torch.config.base import COLLECTIVE_CHOICES, Config
from repro_torch.core import aggregation as agg
from repro_torch.core import channel as ch
from repro_torch.core import energy as energy_mod
from repro_torch.core import quantization as quant
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import sinks as obs_sinks
from repro_torch.obs import tap as obs_tap
from repro_torch.obs.trace import phase_span
from repro_torch.population import errors as pop_errors
from repro_torch.population import fleet as pop_fleet
from repro_torch.population import power as pop_power
from repro_torch.population import telemetry
from repro_torch.sharding.placement import place_model

Batch = Dict[str, torch.Tensor]
GenLike = Union[int, torch.Generator]


def _uniform(gen: Optional[torch.Generator], shape,
             device: torch.device) -> torch.Tensor:
    if gen is None:
        raise ValueError("pass a generator, or the noise tensors")
    return torch.rand(shape, generator=gen, device=device)


def _full_fp32(device: torch.device) -> None:
    """Run the round's float math as the reference does: TF32 off for cuDNN
    convolutions (on by default) and for float32 matrix products, and
    bfloat16 products accumulated in float32 (cuBLAS may otherwise reduce
    a split-K product in bfloat16; the reference's dots accumulate in
    float32 and round the result once) — process-wide settings."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def local_sgd(model, config: Config, params: convert.Flat, batches: Batch,
              gen: Optional[torch.Generator] = None, *,
              u_train: Optional[torch.Tensor] = None
              ) -> Tuple[convert.Flat, torch.Tensor, torch.Tensor]:
    """I local steps of SGD (eq. 4) for K clients at once.

    params: flat (D,) in the model's layout (a buffer per dtype where its
    leaves have more than one); batches leaves (K, I, B, ...).
    Where ``model.quantizes_training`` (the QNN), each step trains through
    the STE fake-quant with noise u_train (K, I, D) (drawn from ``gen``
    when None); the LM, like the reference's, trains on its raw weights.
    Each leaf steps ``w - eta * g`` in its dtype with eta rounded to it
    once, as the reference's ``w - eta * g.astype(w.dtype)`` (a Python
    float takes the array's dtype there); in float32 it rounds once, as
    XLA contracts the reference's into a fused multiply-add
    (``kernels.ops.fma_step_``: the QNN's step is one launch over (K, D)).
    Returns the K local flat parameters (K, D) and each step's loss and
    accuracy, (I, K) each.
    """
    fl, qcfg = config.fl, config.quant
    K, I = batches["labels"].shape[:2]
    p = convert.map_buffers(lambda b: b.detach().expand(K, *b.shape).clone(),
                            params)
    losses, accs = [], []
    for i in range(I):
        batch = {k: v[:, i] for k, v in batches.items()}
        if model.quantizes_training:
            p.requires_grad_(True)
            with torch.enable_grad():
                u = (u_train[:, i] if u_train is not None
                     else _uniform(gen, p.shape, params.device))
                pq = quant.fake_quant_ste(p, u, qcfg.bits, qcfg.clip,
                                          qcfg.stochastic)
                ce, acc = model.loss_stacked(
                    convert.unflatten_params(pq, model.param_shapes), batch)
                (grad,) = torch.autograd.grad(ce.sum(), p)
            p = p.detach()
            _step_(p, grad, fl.learning_rate)
        else:
            ce, acc = sgd_step_(lambda leaves: model.loss_stacked(leaves, batch),
                                p, model.param_shapes, fl.learning_rate)
        losses.append(ce.detach())
        accs.append(acc)
    return p, torch.stack(losses), torch.stack(accs)


def sgd_step_(loss_fn: Callable, flat: convert.Flat,
              layout: convert.Layout, lr: float):
    """One SGD step on the flat parameters ``flat`` (..., D), in place:
    ``loss_fn`` maps the leaves (views by path) to (loss, aux), loss one
    value or one per row; each leaf steps ``w - eta * g`` in its dtype,
    eta the learning rate ``lr`` rounded to it.  The gradients are taken
    by leaf (one of a whole buffer would zero-fill a (..., n) tensor for
    each leaf), and the leaves step in place once the graph is spent: a
    float32 leaf in one ``ops.fma_step_`` launch.  Returns (loss, aux)."""
    views = convert.unflatten_params(flat, layout)
    live = {k: v.detach().requires_grad_(True) for k, v in views.items()}
    with torch.enable_grad():
        loss, aux = loss_fn(live)
        grads = torch.autograd.grad(loss.sum(), list(live.values()))
    for w, g in zip(views.values(), grads):
        _step_(w, g, lr)
    return loss.detach(), aux


def _step_(w: torch.Tensor, g: torch.Tensor, lr: float) -> None:
    """``w - eta * g`` in place, in w's dtype, eta the learning rate
    rounded to it: rounded once in float32 (the reference's contracted
    update, ROADMAP C5), a product and a difference in bfloat16 (the
    reference's rounding there too)."""
    eta = float(torch.tensor(lr, dtype=w.dtype))
    if w.dtype == torch.float32:
        ops.fma_step_(w, g, eta)
    else:
        w.sub_(eta * g)


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
    ``torch.Generator``; ``_round``, ``_fleet_round`` and ``_client_update``
    also take the noise, packet and fleet draws as tensors, so a test can
    inject the reference's own.

    With ``config.fleet.enabled`` the constructor draws the fleet
    (``fleet_state``, seeded by ``fleet.seed``) on the simulator's device,
    and every round runs :meth:`_fleet_round`: the fleet's selection and
    drops replace the i.i.d. packet draws, and the round's telemetry stays
    on the device until the history is built after the last round.
    """

    def __init__(self, model, config: Config, client_store, *,
                 device: DeviceLike = None,
                 macs_per_iter: Optional[float] = None):
        self.device = resolve_device(device)
        if client_store.device.type != self.device.type:
            raise ValueError(f"client store on {client_store.device}, "
                             f"simulator on {self.device}")
        _full_fp32(self.device)
        self.model = model
        self.config = config
        self.store = client_store
        self.shapes = dict(model.param_shapes)
        self.num_params = sum(math.prod(s) for s in self.shapes.values())
        self.alphas = torch.tensor(client_store.client_weights(),
                                   dtype=torch.float32, device=self.device)
        self.macs = macs_per_iter or config.energy.macs_per_iteration
        self._energy: Optional[Tuple[float, float]] = None
        # the population, carried across run_rounds calls (None: the
        # paper's homogeneous i.i.d. cohort)
        self.fleet_state: Optional[pop_fleet.FleetState] = None
        if config.fleet.enabled:
            if config.fleet.size < config.fl.devices_per_round:
                raise ValueError(
                    f"fleet.size={config.fleet.size} smaller than the "
                    f"cohort devices_per_round={config.fl.devices_per_round}")
            self.fleet_state = pop_fleet.init_fleet(config.fleet.seed, config,
                                                    device=self.device)

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
        qcfg = self.config.quant
        p, losses, accs = local_sgd(self.model, self.config, params, batches,
                                    gen, u_train=u_train)
        delta = p - params
        if qcfg.enabled and qcfg.quantize_uplink:
            u = u_up if u_up is not None else _uniform(gen, delta.shape,
                                                       self.device)
            delta = quant.quantize(delta, u, qcfg)
        return delta, losses.mean(0), accs.mean(0)

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

    def _fleet_round(self, params: torch.Tensor, fleet: pop_fleet.FleetState,
                     batches: Batch, client_alphas: torch.Tensor,
                     gen: Optional[torch.Generator] = None, *,
                     draws: Optional[pop_fleet.RoundDraws] = None,
                     u_train: Optional[torch.Tensor] = None,
                     u_up: Optional[torch.Tensor] = None):
        """One fleet round: advance the whole fleet and select the cohort
        (``round_update``, with ``k`` = K), run the K client updates,
        aggregate under the fleet's validity and drops — the unbiased IPW
        aggregate under ``fleet.error_reweight``, else eq. 6 (or eq. 5) —
        and build the round's telemetry as device tensors.  Returns (new
        params, fleet, telemetry)."""
        cfg = self.config
        K = client_alphas.shape[0]
        fleet, info = pop_fleet.round_update(fleet, gen, cfg, self.num_params,
                                             K, draws=draws)
        deltas, losses, accs = self._client_update(params, batches, gen,
                                                   u_train=u_train, u_up=u_up)
        if cfg.fleet.error_reweight:
            new_params = pop_errors.reweighted_aggregate(
                params, deltas, client_alphas, info.valid, info.lam,
                cfg.channel.error_prob, rates=info.rates_sel,
                min_rate=pop_power.min_rate(cfg, self.num_params))
        elif cfg.fl.error_aware:
            new_params = agg.error_aware_aggregate(
                params, deltas, client_alphas * info.valid, info.lam)
        else:
            new_params = agg.naive_aggregate(params, deltas, info.lam)
        tau = (info.valid * pop_fleet.round_latency_s(
            cfg, info.rates_sel, self.num_params, self.macs)).max()
        tel = telemetry.simulator_round_telemetry(
            loss=losses.mean(), accuracy=accs.mean(), selected=info.idx,
            valid=info.valid, lam=info.lam, battery_j=fleet.battery_j,
            charge_j=info.charge_j, tau_s=tau, power_w=fleet.p_last,
            outage_sel=info.outage_sel, cost_sel=info.cost_sel,
            harvest_j=info.harvest_j, error_prob=cfg.channel.error_prob)
        return new_params, fleet, tel

    def _run_rounds_fleet(self, params: torch.Tensor, rounds: int,
                          gen: torch.Generator, *,
                          eval_fn: Optional[Callable] = None,
                          start_round: int = 0,
                          tap: Optional[Callable] = None
                          ) -> Tuple[torch.Tensor, List[dict]]:
        """``rounds`` fleet rounds queued back to back
        (:meth:`_queue_fleet_rounds`), then the history built from their
        stacked telemetry: the one host read."""
        stream = obs_tap.DeferredTap(tap) if tap is not None else None
        params, tels = self._queue_fleet_rounds(params, rounds, gen,
                                                eval_fn=eval_fn, tap=stream)
        if stream is not None:
            stream.flush()
        return params, telemetry.expand_history(telemetry.stack_rounds(tels),
                                                rounds, start_round)

    def _queue_fleet_rounds(self, params: torch.Tensor, rounds: int,
                            gen: torch.Generator, *,
                            eval_fn: Optional[Callable] = None,
                            tap: Optional[Callable] = None
                            ) -> Tuple[torch.Tensor, List[dict]]:
        """Queue ``rounds`` fleet rounds without reading the device (unless
        ``eval_fn`` does); returns the parameters and each round's
        telemetry as device tensors.  ``tap`` gets each round's telemetry
        as it is queued (a :class:`obs.tap.DeferredTap` copies it to the
        host without waiting)."""
        tels = []
        for _ in range(rounds):
            batches, client_alphas = self._round_inputs(gen)
            params, self.fleet_state, tel = self._fleet_round(
                params, self.fleet_state, batches, client_alphas, gen)
            if eval_fn is not None:
                tel["accuracy"] = torch.as_tensor(eval_fn(params),
                                                  dtype=torch.float32,
                                                  device=self.device)
            if tap is not None:
                tap(tel)
            tels.append(tel)
        return params, tels

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
        if self.fleet_state is not None:
            params, (h,) = self._run_rounds_fleet(params, 1, gen)
            return params, RoundTelemetry(h["loss"], h["accuracy"],
                                          h["survivors"], h["energy_j"],
                                          h["tau_s"])
        batches, client_alphas = self._round_inputs(gen)
        new_params, loss, acc, surv = self._round(params, batches,
                                                  client_alphas, gen)
        e, tau = self.round_energy()
        return new_params, RoundTelemetry(float(loss), float(acc),
                                          int(surv), e, tau)

    def run_rounds(self, params: torch.Tensor, rounds: int, gen: GenLike, *,
                   eval_fn: Optional[Callable[[torch.Tensor], float]] = None,
                   start_round: int = 0,
                   tap: Optional[Callable] = None
                   ) -> Tuple[torch.Tensor, List[dict]]:
        """``rounds`` successive :meth:`run_round` calls.  Each history entry
        carries ``round_s``, the round's host time: reading its loss waits
        for the device, so the time covers the round's device work.

        With a fleet the rounds are queued without a host read, and the
        history (no ``round_s``) carries the fleet telemetry: the selected
        devices, drops, battery and assigned-power quantiles, realized
        cohort energy (``energy_j``) and latency, outage and harvest.

        ``tap`` (a host callable taking one round's telemetry dict, usually
        ``obs.scan_sink_tap(sink)``) gets every round, in round order,
        while the call runs: with a fleet the round's telemetry tensors,
        copied to the host without waiting for the device
        (``obs.tap.DeferredTap``); without, the round's loss, accuracy and
        survivors.  Every round has reached the tap when the call returns.
        The tap reads only the rounds' outputs: parameters, fleet and
        history are those of an untapped call.  ``tap=None`` adds
        nothing."""
        gen = make_generator(gen, self.device)
        if self.fleet_state is not None:
            return self._run_rounds_fleet(params, rounds, gen,
                                          eval_fn=eval_fn,
                                          start_round=start_round, tap=tap)
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
            if tap is not None:
                tap({"loss": tel.loss, "accuracy": float(metric),
                     "survivors": tel.survivors})
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
              log_every: int = 0,
              sink: Optional[obs_sinks.MetricsSink] = None
              ) -> Tuple[torch.Tensor, List[dict]]:
        """Run rounds until ``rounds`` or the target accuracy; returns
        (params, history).  ``log_every`` prints every that many rounds
        through ``obs.sinks.ConsoleSink`` (the reference's round line);
        ``sink`` also gets every round's record (kind ``fl_round``) as the
        round runs (:meth:`run_rounds`'s ``tap``)."""
        gen = make_generator(gen, self.device)
        console = obs_sinks.ConsoleSink(log_every=log_every) \
            if log_every else None
        tap = obs_tap.scan_sink_tap(sink) if sink is not None else None
        history: List[dict] = []
        for t in range(rounds):
            params, hist = self.run_rounds(params, 1, gen, eval_fn=eval_fn,
                                           start_round=t, tap=tap)
            h = hist[0]
            history.append(h)
            if console is not None:
                console.emit(obs_sinks.make_record("fl_round", t, h))
            if target_accuracy and h["accuracy"] >= target_accuracy:
                break
        return params, history


# ---------------------------------------------------------------------------
# the cohort round: C cohorts stacked on one device
# ---------------------------------------------------------------------------

_WIRE_TO_COLLECTIVE = {"f32": "paper", "int": "int", "packed": "packed",
                       "ring": "ring", "rsag": "rsag", "auto": "auto"}


class RoundNoise(NamedTuple):
    """Every random draw of one cohort round, so a test can inject the
    reference's own: u_train (C, I, D) fake-quant noise per local step
    (None for a model whose local steps do not fake-quantize, the LM),
    u_up (C, D) uplink rounding noise, lam (C,) packet successes (None
    with a fleet, whose drops decide λ)."""
    u_train: Optional[torch.Tensor]
    u_up: Optional[torch.Tensor]
    lam: Optional[torch.Tensor]


def fl_data_axes(axis_sizes: Sequence[int],
                 config: Optional[Config] = None) -> Tuple[str, ...]:
    """Names of the cohort axes of sizes ``axis_sizes``: the trailing
    entries of ``fl.cohort_axes``, so (10,) is ("data",) and (2, 5) is
    ("pod", "data") under the default."""
    wanted = config.fl.cohort_axes if config is not None else ("pod", "data")
    if len(axis_sizes) > len(wanted):
        raise ValueError(f"{len(axis_sizes)} cohort axes, but "
                         f"fl.cohort_axes names {len(wanted)}: {wanted}")
    return tuple(wanted[len(wanted) - len(axis_sizes):])


def resolve_collective(config: Config, collective: Optional[str]) -> str:
    """Explicit ``collective`` wins; else ``config.quant.wire_format``."""
    if collective is None:
        collective = _WIRE_TO_COLLECTIVE.get(config.quant.wire_format)
        if collective is None:
            raise ValueError(
                f"unknown quant.wire_format {config.quant.wire_format!r}; "
                f"expected one of {sorted(_WIRE_TO_COLLECTIVE)}")
    if collective not in COLLECTIVE_CHOICES:
        raise ValueError(f"unknown collective {collective!r}")
    return collective


def make_fl_round(model, config: Config, axis_sizes: Sequence[int], *,
                  collective: Optional[str] = None,
                  device: DeviceLike = None,
                  tap: Optional[Callable] = None) -> Optional[Callable]:
    """Build the cohort round over C = Π ``axis_sizes`` cohorts.

    collective: "paper" | "int" | "packed" | "ring" | "rsag" | "auto" |
    None (the default: ``config.quant.wire_format``).  Returns None when
    there is no cohort axis, as the reference does.  ``device=None`` means
    the CUDA device.

    The cohorts are stacked row-major over ``axis_sizes``, whose axes are
    the trailing names of ``fl.cohort_axes``: at (P, K) over ("pod",
    "data") cohort (p, d) is row c = p·K + d, the flat shard index of the
    reference's ``P(("pod", "data"))`` batch split.

    Returned fn: ``round_fn(params, batch, gen=None, *, noise=None) ->
    (params, metrics)``, or with ``config.fleet.enabled``
    ``round_fn(params, batch, gen=None, fleet, *, noise=None,
    fleet_draws=None) -> (params, metrics, fleet)``: ``round_update`` runs
    once with ``k`` = C, cohort c reads the fleet's ``lam[c]``, under
    ``fleet.error_reweight`` ``ipw_delta_scale`` multiplies the aggregated
    delta after the collective, and the metrics gain the fleet keys.
    params are the model's flat (D,) parameters (``convert.Layout``: the
    one vector of its dtype, or a buffer per dtype); the uplink's (C, D)
    float32 wire vector holds each cohort's delta in leaf order, so the
    noise, the codes and the wire bits map to the reference's one to one.
    ``batch`` leaves are (global_batch, ...), and cohort c takes rows
    [c·b, (c+1)·b), b = global_batch / C, split into I microbatches with
    the remainder b mod I dropped.  Each cohort's data weight is α = 1/C.
    The draws come from the ``torch.Generator`` ``gen`` or, all of them,
    from ``noise`` (:class:`RoundNoise`, its rows in cohort order; with a
    fleet its ``lam`` is None, and ``fleet_draws`` holds the fleet's).
    ``metrics`` holds the mean loss and the survivors (0-dim tensors),
    ``wire_bits_per_param`` and its per-phase split
    ``wire_phase_bits_per_param``.

    ``tap`` (a host callable taking (metrics, round index), usually
    ``obs.shard0_sink_tap(sink)``, or that wrapped in
    ``obs.tap.DeferredTap`` so the round never waits for the device)
    gets each round's metrics dict; a tapped round takes the keyword
    ``step``, the round's absolute index, which stamps the record, and
    raises ValueError without it.  The tap reads only the metrics.
    ``tap=None`` adds nothing and ``step`` is then ignored.
    """
    collective = resolve_collective(config, collective)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    axes = fl_data_axes(axis_sizes, config)
    if not axes:
        return None
    C = int(math.prod(axis_sizes))
    plan = agg.make_wire_plan(collective, config.quant, axes, axis_sizes)
    return _make_round(model, config, C, plan, resolve_device(device),
                       _Cohorts(slice(None), lambda gen, noise: noise,
                                agg.aggregate, _same, _same), tap)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


class _Cohorts(NamedTuple):
    """The cohorts one process of the round holds, and how it reduces over
    the others: every cohort stacked (:func:`make_fl_round`), or one a rank
    (:func:`make_dist_fl_round`)."""
    rows: slice         # this process's rows of the C cohorts
    draws: Callable     # (gen, noise) -> its rows' RoundNoise, or None to
                        # draw from gen as the round goes
    aggregate: Callable  # (plan, delta, alpha, lam, u) -> the (D,) delta
    mean: Callable      # the loss over every cohort
    sum: Callable       # the survivors over every cohort


def _make_round(model, config: Config, C: int, plan: agg.WirePlan, dev,
                cohorts: _Cohorts, tap: Optional[Callable]) -> Callable:
    """The cohort round over C cohorts from one process holding
    ``cohorts.rows`` of them (see :func:`make_fl_round`)."""
    fl, qcfg = config.fl, config.quant
    _full_fp32(dev)
    I = fl.local_iters
    layout = model.param_shapes
    D = layout.numel
    # the fleet prices the whole model's delta, wherever its blocks lie
    placement = getattr(model, "placement", None)
    D_model = placement.full.numel if placement is not None else D
    quantize_up = qcfg.enabled and qcfg.quantize_uplink
    with_fleet = config.fleet.enabled
    if with_fleet and config.fleet.size < C:
        raise ValueError(f"fleet.size={config.fleet.size} smaller than the "
                         f"cohort count {C}")

    def round_fn(params: convert.Flat, batch: Batch,
                 gen: Optional[torch.Generator] = None,
                 fleet: Optional[pop_fleet.FleetState] = None, *,
                 noise: Optional[RoundNoise] = None,
                 fleet_draws: Optional[pop_fleet.RoundDraws] = None,
                 step: Optional[int] = None):
        if tap is not None and step is None:
            raise ValueError(
                "a tapped round needs its step index: call the round with "
                "step= so each streamed record carries its true round")
        layout.check(params, device=dev)
        if noise is None and gen is None:
            raise ValueError("pass a generator, or the noise tensors")
        if (fleet is not None) != with_fleet:
            raise ValueError("pass the fleet exactly when config.fleet is "
                             "enabled")
        if with_fleet:
            if noise is not None and noise.lam is not None:
                raise ValueError("with a fleet, λ comes from the fleet: "
                                 "noise.lam must be None")
            fleet, info = pop_fleet.round_update(fleet, gen, config, D_model,
                                                 C, draws=fleet_draws)
        noise = cohorts.draws(gen, noise)
        batches = _cohort_batches(batch, C, I, cohorts.rows)
        u_train = noise.u_train if noise is not None else None
        with phase_span("fl/local_steps"):
            p, losses, _ = local_sgd(model, config, params, batches, gen,
                                     u_train=u_train)
        if with_fleet:
            lam = info.lam[cohorts.rows]
        elif noise is not None:
            lam = noise.lam
        else:
            lam = ch.sample_packet_success(gen, (C,),
                                           config.channel.error_prob)
        if noise is not None:
            u_up = noise.u_up
        else:
            u_up = _uniform(gen, (C, D), dev) if quantize_up else None
        delta = _delta(p, params, layout)
        del p
        agg_delta = cohorts.aggregate(plan, delta, 1.0 / C, lam, u_up)
        del delta
        fleet_metrics = None
        if with_fleet:
            if config.fleet.error_reweight:
                agg_delta = agg_delta * pop_errors.ipw_delta_scale(
                    info.lam, info.valid, info.rates_sel,
                    config.channel.error_prob,
                    min_rate=pop_power.min_rate(config, D_model))
            fleet_metrics = telemetry.fleet_round_metrics(
                battery_j=fleet.battery_j, valid=info.valid,
                charge_j=info.charge_j, power_w=fleet.p_last,
                outage_sel=info.outage_sel, cost_sel=info.cost_sel,
                harvest_j=info.harvest_j,
                error_prob=config.channel.error_prob)
        metrics = telemetry.distributed_metrics(
            plan, loss=cohorts.mean(losses.mean()),
            survivors=cohorts.sum(lam.sum()), fleet=fleet_metrics)
        new = _apply(params, agg_delta, layout)
        if tap is not None:
            tap(metrics, step)
        return (new, metrics, fleet) if with_fleet else (new, metrics)

    return round_fn


def _cohort_batches(batch: Batch, C: int, I: int, cohorts: slice) -> Batch:
    """The rows of ``cohorts`` of the global batch split over C cohorts:
    cohort c's rows [c·b, (c+1)·b), b = global_batch / C, as I
    microbatches with the remainder b mod I dropped; leaves (len(cohorts),
    I, b // I, ...)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % C:
            raise ValueError(f"global batch {v.shape[0]} does not split "
                             f"over {C} cohorts")
        mb = v.shape[0] // C // I
        v = v.reshape(C, v.shape[0] // C, *v.shape[1:])[cohorts, :I * mb]
        out[k] = v.reshape(v.shape[0], I, mb, *v.shape[2:])
    return out


# ---------------------------------------------------------------------------
# the distributed cohort round: one cohort a process
# ---------------------------------------------------------------------------

def _round_seed(gen: torch.Generator) -> int:
    """The round's seed, drawn from its generator: the same draw on every
    rank, which all hold the same generator state."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))


def _cohort_stream(seed: int, cohort: int, device) -> torch.Generator:
    """Cohort ``cohort``'s stream for the round of ``seed``: the cohort
    index folded into the seed, as the reference's ``_shard_rng`` folds in
    the indices on the data axes only, so the replicas of a cohort draw
    the same values."""
    mixed = (seed ^ ((cohort + 1) * 0x9E3779B97F4A7C15)) & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def cohort_noise(model, config: Config, gen: torch.Generator,
                 D: int) -> RoundNoise:
    """One cohort's draws from its stream ``gen``, in the order the round
    makes them: the fake-quant noise of each local step (a model that
    trains quantized), λ (none with a fleet, whose drops decide it) and the
    uplink noise; rows (1, ...) of a :class:`RoundNoise`."""
    dev = gen.device
    u_train = (torch.stack([_uniform(gen, (1, D), dev)
                            for _ in range(config.fl.local_iters)], 1)
               if model.quantizes_training else None)
    lam = (None if config.fleet.enabled else ch.sample_packet_success(
        gen, (1,), config.channel.error_prob))
    qcfg = config.quant
    u_up = (_uniform(gen, (1, D), dev)
            if qcfg.enabled and qcfg.quantize_uplink else None)
    return RoundNoise(u_train, u_up, lam)


def dist_round_noise(model, config: Config, gen: torch.Generator, C: int,
                     D: int) -> RoundNoise:
    """Every cohort's draws of one distributed round from the round's
    generator ``gen`` (taken after the fleet's update, where a fleet runs),
    stacked in cohort order: the draws the C ranks make, as the
    :class:`RoundNoise` that gives the stacked round the same."""
    seed = _round_seed(gen)
    rows = [cohort_noise(model, config, _cohort_stream(seed, c, gen.device),
                         D) for c in range(C)]
    return RoundNoise(*(torch.cat(t) if t[0] is not None else None
                        for t in zip(*rows)))


def make_dist_fl_round(model, config: Config, comm, *,
                       collective: Optional[str] = None,
                       tap: Optional[Callable] = None) -> Callable:
    """The cohort round from one rank of ``comm`` (``core.comm.Comm``): the
    reference's ``make_fl_round`` under ``shard_map``, one cohort a
    process, the cohorts those of ``comm.axes`` (the mesh's cohort axes).

    The returned fn has :func:`make_fl_round`'s signature and returns what
    it returns, on every rank: the rank's parameters, the metrics, and with
    a fleet the fleet.  The parameters are the rank's blocks in the local
    layout of ``sharding.placement.place_model(model, config, comm)``
    (the model's own layout where the rules shard no leaf over "model");
    the model axis's ranks of a cohort hold its blocks, and their
    replicated leaves stay equal.  ``train.zero_over_model`` at model > 1
    raises ``NotImplementedError``.
    Rank c (``comm.cohort``, its index over the cohort axes only) takes
    rows [c·b, (c+1)·b) of the global batch, runs :func:`local_sgd` with
    one cohort (the forward tensor-parallel over the model group), and
    uplinks its (1, D_local) delta through ``aggregation.aggregate_rank``
    over the cohort group of the ranks that share its model index; the
    loss (the same on every model rank) is ``pmean``-ed and the survivors
    ``psum``-ed.  Draws: row c of an injected ``noise`` (:class:`RoundNoise`
    over all C cohorts and every parameter, as the stacked round takes
    it), else :func:`cohort_noise` from the cohort's own stream, a seed
    drawn from ``gen`` with c folded in (:func:`dist_round_noise` gives
    every cohort's); a rank keeps the entries of its blocks
    (``Placement.take_wire``).  The fleet's ``round_update`` runs
    replicated on every rank from the same ``gen`` state, priced at the
    whole model's D, and rank c reads ``lam[c]``; the IPW scale multiplies
    the aggregate after the collective.  ``Comm.broadcast_`` makes a
    cohort group's parameters equal once.  ``tap`` is called on every rank
    where it is not None (``obs.tap.rank0_sink_tap`` gives one on rank 0
    only)."""
    collective = resolve_collective(config, collective)
    missing = [a for a in comm.axes if a not in config.fl.cohort_axes]
    if missing:
        raise ValueError(f"comm's axes {missing} are not in fl.cohort_axes "
                         f"{config.fl.cohort_axes}")
    model = place_model(model, config, comm)
    C, c = comm.num_cohorts, comm.cohort
    plan = agg.make_wire_plan(collective, config.quant, comm.axes,
                              comm.axis_sizes)
    placement = getattr(model, "placement", None)
    D = (placement.full if placement is not None
         else model.param_shapes).numel

    def draws(gen: Optional[torch.Generator],
              noise: Optional[RoundNoise]) -> RoundNoise:
        if noise is None:
            noise = cohort_noise(model, config, _cohort_stream(
                _round_seed(gen), c, gen.device), D)
        else:
            noise = RoundNoise(*(t[c:c + 1] if t is not None else None
                                 for t in noise))
        if placement is None:
            return noise
        take = lambda t: placement.take_wire(t) if t is not None else None
        return RoundNoise(take(noise.u_train), take(noise.u_up), noise.lam)

    def aggregate(plan, delta, alpha, lam, u):
        return agg.aggregate_rank(plan, comm, delta, alpha, lam, u)

    return _make_round(model, config, C, plan, comm.device,
                       _Cohorts(slice(c, c + 1), draws, aggregate,
                                comm.pmean, comm.psum), tap)


def _delta(p: convert.Flat, params: convert.Flat,
           layout: convert.Layout) -> torch.Tensor:
    """The (C, D) float32 wire vector of the reference's ``(p_local -
    params).astype(f32)`` leaf by leaf, in leaf order: XLA computes the
    difference of the two upcast operands, unrounded to their dtype.  One
    tensor in one subtraction; buffers one run of leaves at a time."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.float32).sub_(params)
    out = torch.empty((p[0].shape[0], layout.numel), dtype=torch.float32,
                      device=p[0].device)
    for b, o, w, n in layout.runs:
        out[:, w:w + n].copy_(p[b][:, o:o + n]).sub_(params[b][o:o + n])
    return out


def _apply(params: convert.Flat, agg_delta: torch.Tensor,
           layout: convert.Layout) -> convert.Flat:
    """The reference's ``w + d.astype(w.dtype)`` leaf by leaf: the float32
    aggregate (D,) rounded to each leaf's dtype, then added in it
    (``layout`` maps it onto the buffers where ``params`` has several)."""
    with phase_span("fl/apply"):
        if isinstance(params, torch.Tensor):
            return params + agg_delta.to(params.dtype)
        new = tuple(torch.empty_like(b) for b in params)
        for b, o, w, n in layout.runs:
            torch.add(params[b][o:o + n], agg_delta[w:w + n].to(new[b].dtype),
                      out=new[b][o:o + n])
        return new
