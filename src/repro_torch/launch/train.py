"""The trainer: the paper's Algorithm 1 as the cohort FL round, or the
standard SGD step, with the reference trainer's flags.

    python -m repro_torch.launch.train --arch olmo-1b --devices 8 \
        --collective rsag train.global_batch=12 train.seq_len=512 --steps 3

``--devices N`` picks the mesh the reference builds for N devices: (2, 4)
("data", "model") at 8, (16, 16) at 256, (2, 16, 16) ("pod", "data",
"model") at 512 and more; 0 means one device.  C = the product of the
cohort axes' sizes (``fl.cohort_axes`` found on the mesh).  Without
``--backend`` the C cohorts run stacked on one device.  With it the
trainer runs distributed, one process a mesh position:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --backend gloo --arch olmo-1b --collective rsag ...

Rank, world size and local rank come from the environment ``torchrun``
sets (RANK, WORLD_SIZE, LOCAL_RANK; ``--init-method`` "env://"), the mesh
is the reference's for the world size, (1, world) below its 4-device
debug mesh, its "data" axis named for the config's last cohort axis where
the config has none ("pod" for deepseek-v3), and each rank runs its cohort
through ``core.fl.make_dist_fl_round`` over real collectives
(``core.comm``).  "nccl" takes one card a rank (cuda:LOCAL_RANK); "gloo"
runs on the CPU (``main(..., device="cpu")``) or lets several ranks share
a card (cuda:LOCAL_RANK mod the cards), staging every payload through
pinned host memory.  The ranks of the "model" axis hold their cohort's
model as ``sharding.rules`` places it (``sharding.placement``): a dense
decoder or a MoE (granite, deepseek-v3 with MLA) tensor-parallel, each
rank its blocks of the sharded leaves, built from the seed a leaf at a
time; the QNN, whose leaves the rules never shard, as replicas; RWKV-6
and the Griffin hybrid, whose tensor-parallel forward is not ported,
raise at a model axis above 1.  The first rank of each cohort
group broadcasts its parameters over the group.  Rank 0 alone writes
checkpoints and telemetry: the whole tree, each sharded leaf gathered over
the model group as it is written (the file a single process writes; the
others take part in the gathers, then wait at a barrier), and a restore
takes each rank's blocks.  Stacked, the "model" axis runs unsharded.
Any ``key=value`` positional argument overrides that config field
(``model.n_layers=2 quant.bits=4``).  Its batches are token
batches (``data.synthetic.token_batch``), as the reference trainer's, so
it refuses an encoder-decoder (whisper-base), whose loss needs frames:
the reference's trainer cannot train one either.

The fleet flags (``--fleet-size``, ``--selection``, ``--power-policy``,
``--power-max``) switch on the heterogeneous device population of
``population``: its ``FleetState`` threads through the step loop.

Checkpoints (``--checkpoint-dir D`` / ``--checkpoint-every N``), as the
reference's: where ``D`` holds a checkpoint, the run restores the
parameters from its latest step and, when a fleet runs and ``D/fleet``
holds one, the ``FleetState`` (a legacy 6-leaf fleet is migrated), then
runs from that step to ``--steps`` with a fresh generator seeded
``fl.seed + 1``, as the reference restarts its key chain: a resumed run
draws the batches and noise of steps 0, 1, ... again.  After each step
with ``(step + 1) % N == 0`` it saves the parameters to ``D`` and the
fleet to ``D/fleet`` (``checkpoint``, the reference's msgpack files: each
package reads the other's).

Streaming telemetry (``--telemetry-dir T`` / ``--telemetry-every N``):
one versioned ``train_step`` record per FL round appended to
``T/telemetry.jsonl``, stamped with the absolute step (so a resumed run
appends a monotonic stream), every N-th step kept.  The records reach the
file without the step waiting for the device (``obs.tap.DeferredTap``);
at the end the run synchronizes and writes the rest.  The standard step
has no FL round: its stream is closed and the run prints "stream off".

``main(argv, device=None)`` runs on the CUDA device and raises without
one; pass ``device="cpu"`` to run on the CPU (the kernels' plain
versions).  Tokens per second are read after the step's loss has reached
the host, which waits for the device.
"""
from __future__ import annotations

import argparse
import functools
import math
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.config.base import (COLLECTIVE_CHOICES, POWER_POLICIES,
                                     SELECTION_POLICIES, apply_overrides)
from repro_torch.configs import get_config
from repro_torch.core import comm as comm_mod
from repro_torch.core import fl as fl_mod
from repro_torch.data.synthetic import token_batch
from repro_torch.device import (DeviceLike, make_generator, resolve_device,
                                seconds_since)
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (cohort_axis_sizes, make_mesh,
                                     mesh_for_devices)
from repro_torch.models import build_model
from repro_torch.obs import sinks as obs_sinks
from repro_torch.obs import tap as obs_tap
from repro_torch.population import fleet as pop_fleet
from repro_torch.sharding.placement import gather_block, place_model


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--devices", type=int, default=0,
                    help="build the reference's mesh for N devices; its "
                         "cohorts run stacked on one device (0 = one)")
    ap.add_argument("--collective", default=None,
                    choices=list(COLLECTIVE_CHOICES),
                    help="wire format; 'auto' picks the byte-minimal mode "
                         "for the mesh (default: quant.wire_format from "
                         "config)")
    ap.add_argument("--fleet-size", type=int, default=0,
                    help="enable the heterogeneous device population with "
                         "this many devices (fleet.size override; 0 keeps "
                         "the paper's homogeneous cohort)")
    ap.add_argument("--selection", default=None,
                    choices=list(SELECTION_POLICIES),
                    help="fleet cohort selection policy (fleet.selection "
                         "override)")
    ap.add_argument("--power-policy", default=None,
                    choices=list(POWER_POLICIES),
                    help="per-device uplink power policy (power.policy "
                         "override; default 'fixed' = the paper's scalar)")
    ap.add_argument("--power-max", type=float, default=0.0,
                    help="cap on the assignable per-device tx power in W "
                         "(power.p_max override)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="",
                    help="resume from the latest checkpoint here (and the "
                         "fleet's in its fleet/ directory), and save to it "
                         "(off when empty)")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="save after every N-th step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry-dir", default="",
                    help="stream one JSONL telemetry record per FL round "
                         "here while the run goes on (off when empty)")
    ap.add_argument("--telemetry-every", type=int, default=1,
                    help="keep every N-th telemetry record (default 1)")
    ap.add_argument("--backend", default=None, choices=list(comm_mod.BACKENDS),
                    help="run distributed, one process a mesh position "
                         "(launch with torchrun); off when absent")
    ap.add_argument("--init-method", default="env://",
                    help="the process group's rendezvous (env:// reads "
                         "torchrun's environment; file://PATH a FileStore)")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_intermixed_args(argv)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    """Run the trainer; returns the last step's metrics (host floats), the
    run's shape {"kind", "mesh", "cohorts", "steps", "loss", ...}, the step
    it started from ("start_step": the restored step, else 0), the final
    "params" (a rank's blocks under tensor parallelism) and "fleet" (None
    without one), and where it saved, restored
    or streamed, the seconds that took ("save_s", "restore_s") and the
    records written ("telemetry_records"); its "rank" (0 unless
    distributed) and, distributed, the payload bytes it sent by collective
    ("comm_sent") and its host-staging seconds ("staging_s").  With
    ``--backend`` it joins the process group and leaves it on return."""
    args = parse_args(argv)
    if args.backend is None:
        return _train(args, resolve_device(device), None)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device is not None:
        dev = torch.device(device)
    else:
        resolve_device(None)                   # raises without a card
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local if args.backend == "nccl"
                           else local % cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    comm_mod.init_process_group(args.backend, rank, world, dev,
                                init_method=args.init_method)
    try:
        return _train(args, dev, world)
    finally:
        comm_mod.destroy_process_group()


def _quiet(*_args, **_kw) -> None:
    pass


def _train(args: argparse.Namespace, dev: torch.device,
           world: Optional[int]) -> dict:
    """The trainer on ``dev``: stacked where ``world`` is None, else
    distributed over the joined process group of ``world`` ranks."""
    rank = 0 if world is None else dist.get_rank()
    log = print if rank == 0 else _quiet

    overrides = tuple(args.overrides)
    if args.fleet_size:
        overrides += (f"fleet.size={args.fleet_size}",)
    if args.selection:
        overrides += (f"fleet.selection={args.selection}",)
    if args.power_policy:
        overrides += (f"power.policy={args.power_policy}",)
    if args.power_max:
        overrides += (f"power.p_max={args.power_max}",)
    cfg = apply_overrides(get_config(args.arch), overrides)
    if cfg.model.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.model.name}: the trainer draws token batches only "
            f"(data.synthetic.token_batch, as the reference's trainer), "
            f"which carry no encoder frames, so it cannot train an "
            f"encoder-decoder; train one through core.fl.make_fl_round "
            f"with a batch that carries 'frames' (ROADMAP, reference "
            f"caveats)")
    model = build_model(cfg)
    comm = None
    if world is None:
        mesh = mesh_for_devices(args.devices or 1)
    else:
        mesh = (mesh_for_devices(world) if world >= 4
                else make_mesh((1, world), ("data", "model")))
        axis = cfg.fl.cohort_axes[-1]
        if axis not in mesh:
            mesh = {axis if a == "data" else a: n for a, n in mesh.items()}
        if args.devices and args.devices != world:
            raise ValueError(f"--devices {args.devices} on {world} ranks: "
                             f"the distributed mesh is the world's")
        if math.prod(mesh.values()) != world:
            raise ValueError(f"the reference's mesh for {world} devices is "
                             f"{mesh}, which {world} ranks do not fill: "
                             f"launch 1 to 3 ranks or a multiple of 4")
        comm = comm_mod.Comm(mesh, cfg.fl.cohort_axes, dev)
        model = place_model(model, cfg, comm)
    log(f"mesh: {mesh}  arch: {cfg.model.name} "
        f"({cfg.model.param_count()/1e6:.1f}M params) on {dev}")

    steps = args.steps or cfg.train.steps
    collective = fl_mod.resolve_collective(cfg, args.collective)
    sink = tap = None
    if args.telemetry_dir and rank == 0:
        sink = obs_sinks.JsonlSink(args.telemetry_dir)
    if args.telemetry_dir:
        tap = obs_tap.rank0_sink_tap(sink, rank, kind="train_step",
                                     every=max(1, args.telemetry_every))
    step_fn, kind = steps_mod.make_train_step(model, cfg, mesh,
                                              collective=collective,
                                              device=dev, tap=tap, comm=comm)
    if sink is not None and kind == "standard":
        sink.close()
        sink = tap = None
        log("telemetry: no FL round on this mesh/config — stream off")
    elif sink is not None:
        log(f"telemetry: streaming train_step records -> {sink.path}")
    cohorts = (math.prod(cohort_axis_sizes(mesh, cfg.fl.cohort_axes))
               if kind != "standard" else 1)
    placement = getattr(model, "placement", None)
    where = (f"stacked on {dev}" if comm is None else
             f"one a process over {world} {comm.backend} ranks"
             f"{' with host staging' if comm.staged else ''}")
    model_axis = ("unsharded" if comm is None else
                  f"tensor-parallel over {comm.model_size} ranks"
                  if placement is not None else "replicas")
    log(f"step kind: {kind} (collective={collective}, "
        f"quant bits={cfg.quant.bits}, q={cfg.channel.error_prob}, "
        f"{cohorts} cohorts {where}, model axis {model_axis})")
    fleet = None
    if kind == "fleet_fl_round":
        fleet = pop_fleet.init_fleet(cfg.fleet.seed, cfg, device=dev)
        log(f"fleet: {cfg.fleet.size} devices, "
            f"selection={cfg.fleet.selection}, "
            f"rho={cfg.fleet.fading_rho}, "
            f"battery={cfg.fleet.battery_j}J")

    params = model.init_flat(cfg.fl.seed, device=dev)
    out = {"kind": kind, "mesh": mesh, "cohorts": cohorts, "steps": 0,
           "start_step": 0, "rank": rank}
    ckpt_dir = args.checkpoint_dir
    fleet_dir = os.path.join(ckpt_dir, "fleet") if ckpt_dir else ""
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        t0 = time.perf_counter()
        out["start_step"] = out["steps"] = ckpt.latest_step(ckpt_dir)
        params = ckpt.restore_params(ckpt_dir, params, model.param_shapes,
                                     placement=placement)
        log(f"restored checkpoint step {out['start_step']}")
        if fleet is not None and ckpt.latest_step(fleet_dir) is not None:
            # the same population goes on: drained batteries, fading
            # chain and cursor, not a fresh round-0 fleet
            fleet = pop_fleet.restore_fleet_checkpoint(fleet_dir, fleet)
            log(f"restored fleet state step {ckpt.latest_step(fleet_dir)}")
        out["restore_s"] = seconds_since(t0, dev)
    if comm is not None:
        comm.broadcast_(params)
    start = out["start_step"]
    gen = make_generator(cfg.fl.seed + 1, dev)
    t0 = time.perf_counter()
    for step in range(start, steps):
        batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                            cfg.model.vocab_size)
        step_kw = {"step": step} if tap is not None else {}
        if fleet is not None:
            params, metrics, fleet = step_fn(params, batch, gen, fleet,
                                             **step_kw)
        else:
            params, metrics = step_fn(params, batch, gen, **step_kw)
        out["steps"] = step + 1
        if ckpt_dir and (step + 1) % args.checkpoint_every == 0:
            ts = time.perf_counter()
            gather = (None if placement is None else
                      functools.partial(gather_block, model))
            if rank == 0:
                ckpt.save_params(ckpt_dir, step + 1, params,
                                 model.param_shapes, gather=gather)
                if fleet is not None:
                    ckpt.save_checkpoint(fleet_dir, step + 1, fleet)
            elif gather is not None:
                for _ in ckpt.param_leaves(params, model.param_shapes,
                                           gather):
                    pass
            if comm is not None:
                comm.barrier()
            out["save_s"] = out.get("save_s", 0.0) + seconds_since(ts, dev)
        if step % args.log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])          # waits for the step
            tok_s = (cfg.train.global_batch * cfg.train.seq_len
                     * (step - start + 1)) / (time.perf_counter() - t0)
            out.update(loss=loss, tok_s=tok_s)
            extra = ""
            if "survivors" in metrics:
                out["survivors"] = float(metrics["survivors"])
                extra = f" survivors={out['survivors']:.0f}"
            if "wire_bits_per_param" in metrics:
                out["wire_bits_per_param"] = float(
                    metrics["wire_bits_per_param"])
                extra += (" wire_bits/param="
                          f"{out['wire_bits_per_param']:.2f}")
            if "battery_q50_j" in metrics:
                extra += (f" batt_med={float(metrics['battery_q50_j']):.1f}J"
                          f" E_round={float(metrics['cohort_energy_j']):.2f}J")
            if "power_q50_w" in metrics:
                extra += (f" p_med={float(metrics['power_q50_w']):.3f}W"
                          f" outage={float(metrics['outage_rate']):.3f}")
            log(f"step {step:5d} loss={loss:.4f} tok/s={tok_s:,.0f}{extra}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["seconds"] = time.perf_counter() - t0
    out["params_finite"] = all(bool(torch.isfinite(b).all())
                               for b in convert.buffers(params))
    out["params"], out["fleet"] = params, fleet
    if comm is not None:
        out.update(comm_sent=dict(comm.sent), staging_s=comm.staging_s)
    log(f"done: {out['steps'] - start} steps in {out['seconds']:.1f}s")
    if sink is not None:
        tap.flush()
        sink.close()
        out["telemetry_records"] = sink.emitted
        log(f"telemetry: {sink.emitted} records -> {sink.path}")
    return out


if __name__ == "__main__":
    main()
