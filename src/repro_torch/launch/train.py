"""The trainer: the paper's Algorithm 1 as the cohort FL round, or the
standard SGD step, with the reference trainer's flags.

    python -m repro_torch.launch.train --arch olmo-1b --devices 8 \
        --collective rsag train.global_batch=12 train.seq_len=512 --steps 3

``--devices N`` picks the mesh the reference builds for N devices: (2, 4)
("data", "model") at 8, (16, 16) at 256, (2, 16, 16) ("pod", "data",
"model") at 512 and more; 0 means one device.  The port runs every cohort
of that mesh stacked on one device, C = the product of the cohort axes'
sizes (``fl.cohort_axes`` found on the mesh); the "model" axis runs
unsharded.  Any ``key=value`` positional argument overrides that config
field (``model.n_layers=2 quant.bits=4``).

The fleet flags (``--fleet-size``, ``--selection``, ``--power-policy``,
``--power-max``) switch on the heterogeneous device population of
``population``: its ``FleetState`` threads through the step loop.

``--checkpoint-dir`` and ``--telemetry-dir`` raise: checkpoints come with
ROADMAP A12, streamed telemetry with A11.

``main(argv, device=None)`` runs on the CUDA device and raises without
one; pass ``device="cpu"`` to run on the CPU (the kernels' plain
versions).  Tokens per second are read after the step's loss has reached
the host, which waits for the device.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import List, Optional

import torch

from repro_torch.config.base import (COLLECTIVE_CHOICES, POWER_POLICIES,
                                     SELECTION_POLICIES, apply_overrides)
from repro_torch.configs import get_config
from repro_torch.core import fl as fl_mod
from repro_torch.data.synthetic import token_batch
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import cohort_axis_sizes, mesh_for_devices
from repro_torch.models import build_model
from repro_torch.population import fleet as pop_fleet


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
                    help="not ported yet (ROADMAP A12): raises")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--telemetry-dir", default="",
                    help="not ported yet (ROADMAP A11): raises")
    ap.add_argument("--telemetry-every", type=int, default=1)
    ap.add_argument("overrides", nargs="*")
    return ap.parse_intermixed_args(argv)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    """Run the trainer; returns the last step's metrics (host floats) and
    the run's shape: {"kind", "mesh", "cohorts", "steps", "loss", ...}."""
    args = parse_args(argv)
    if args.checkpoint_dir:
        raise NotImplementedError("--checkpoint-dir: checkpoints are not "
                                  "ported yet (ROADMAP A12)")
    if args.telemetry_dir:
        raise NotImplementedError("--telemetry-dir: streamed telemetry is "
                                  "not ported yet (ROADMAP A11)")
    dev = resolve_device(device)

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
    model = build_model(cfg)
    mesh = mesh_for_devices(args.devices or 1)
    print(f"mesh: {mesh}  arch: {cfg.model.name} "
          f"({cfg.model.param_count()/1e6:.1f}M params) on {dev}")

    steps = args.steps or cfg.train.steps
    collective = fl_mod.resolve_collective(cfg, args.collective)
    step_fn, kind = steps_mod.make_train_step(model, cfg, mesh,
                                              collective=collective,
                                              device=dev)
    cohorts = (math.prod(cohort_axis_sizes(mesh, cfg.fl.cohort_axes))
               if kind != "standard" else 1)
    print(f"step kind: {kind} (collective={collective}, "
          f"quant bits={cfg.quant.bits}, q={cfg.channel.error_prob}, "
          f"{cohorts} cohorts stacked on {dev}, model axis unsharded)")
    fleet = None
    if kind == "fleet_fl_round":
        fleet = pop_fleet.init_fleet(cfg.fleet.seed, cfg, device=dev)
        print(f"fleet: {cfg.fleet.size} devices, "
              f"selection={cfg.fleet.selection}, "
              f"rho={cfg.fleet.fading_rho}, "
              f"battery={cfg.fleet.battery_j}J")

    params = model.init_flat(cfg.fl.seed, device=dev)
    gen = make_generator(cfg.fl.seed + 1, dev)
    out = {"kind": kind, "mesh": mesh, "cohorts": cohorts, "steps": 0}
    t0 = time.perf_counter()
    for step in range(steps):
        batch = token_batch(gen, cfg.train.global_batch, cfg.train.seq_len,
                            cfg.model.vocab_size)
        if fleet is not None:
            params, metrics, fleet = step_fn(params, batch, gen, fleet)
        else:
            params, metrics = step_fn(params, batch, gen)
        out["steps"] = step + 1
        if step % args.log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])          # waits for the step
            tok_s = (cfg.train.global_batch * cfg.train.seq_len
                     * (step + 1)) / (time.perf_counter() - t0)
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
            print(f"step {step:5d} loss={loss:.4f} tok/s={tok_s:,.0f}{extra}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["seconds"] = time.perf_counter() - t0
    out["params_finite"] = bool(torch.isfinite(params).all())
    print(f"done: {out['steps']} steps in {out['seconds']:.1f}s")
    return out


if __name__ == "__main__":
    main()
