"""The server: prefill a batch of prompts, then greedy-decode new
tokens, with the reference's flags.

    python -m repro_torch.launch.serve --arch olmo-1b --batch 8 \
        --prompt-len 64 --new-tokens 16

``--devices N`` prints the mesh the reference builds for N devices
(``launch.mesh.mesh_for_devices``; 0 means one); the port serves
unsharded on one device.  Any ``key=value`` positional argument overrides
that config field (``model.n_layers=2``).  The cache is sized for the
prompt and the new tokens (``LM.prefill``'s ``max_len``), so the decode
never overwrites a prompt position; the reference sizes it for the prompt
alone and, past it, overwrites the earliest.  An encoder-decoder
(whisper-base) prefills from standard normal frames (B, encoder_seq_len,
d_model) drawn from the port's generator, as the reference draws them,
and sizes its self-attention cache the same way (the reference's prefill
call there takes no ``max_len``).

``--telemetry-dir DIR`` streams one versioned ``serve_decode`` record a
decode step (``latency_s``, ``tokens_per_s``) to ``DIR/telemetry.jsonl``
(``obs.sinks.JsonlSink``, the reference's schema).  A step's latency needs
the device to finish the step, so only a run with telemetry synchronizes
each step; without it the steps queue on the device and the run waits
once, at the end.

``main(argv, device=None)`` runs on the CUDA device and raises without
one; pass ``device="cpu"`` to run on the CPU.  Matrix products and
convolutions run at full float32 precision, as the reference's, as the
trainer's.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.config.base import apply_overrides
from repro_torch.configs import get_config
from repro_torch.core import fl as fl_mod
from repro_torch.device import (DeviceLike, make_generator, resolve_device,
                                seconds_since)
from repro_torch.launch.inputs import random_frames, random_tokens
from repro_torch.launch.mesh import mesh_for_devices
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build_model
from repro_torch.obs import sinks as obs_sinks


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--devices", type=int, default=0,
                    help="print the reference's mesh for N devices; the "
                         "port serves on one (0 = one)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--telemetry-dir", default="",
                    help="stream one serve_decode JSONL record per decode "
                         "step here (off when empty)")
    ap.add_argument("overrides", nargs="*")
    return ap.parse_intermixed_args(argv)


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> dict:
    """Serve once; returns what it printed: the "mesh", "prefill_ms",
    "decode_ms", "tok_s", the generated "tokens" (B, 1 + new tokens) on
    the host, the final cache's "length", where telemetry streamed the
    "telemetry_records" and their "telemetry_path", and on a card
    "max_memory_allocated"."""
    args = parse_args(argv)
    dev = resolve_device(device)
    fl_mod._full_fp32(dev)

    cfg = apply_overrides(get_config(args.arch), tuple(args.overrides))
    model = build_model(cfg)
    mesh = mesh_for_devices(args.devices or 1)
    print(f"mesh {mesh}; {cfg.model.name} "
          f"({cfg.model.param_count()/1e6:.1f}M params), unsharded on {dev}")

    B, P, N = args.batch, args.prompt_len, args.new_tokens
    params = model.init(0, device=dev)
    prompts = random_tokens((B, P), cfg.model.vocab_size,
                            make_generator(1, dev))
    inputs = (prompts,)
    if cfg.model.is_encoder_decoder:
        inputs += (random_frames(cfg, B, make_generator(2, dev)),)
    prefill = make_prefill_step(model, cfg)
    decode = make_decode_step(model, cfg)
    out = {"mesh": mesh}

    t0 = time.perf_counter()
    logits, cache = prefill(params, *inputs, max_len=P + N)
    out["prefill_ms"] = seconds_since(t0, dev) * 1e3
    print(f"prefill {B}x{P}: {out['prefill_ms']:.0f} ms")

    sink = obs_sinks.JsonlSink(args.telemetry_dir) if args.telemetry_dir else None
    tok = logits.reshape(B, -1).argmax(-1)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(N):
        ts = time.perf_counter()
        logits, cache = decode(params, cache, tok)
        tok = logits[:, -1].argmax(-1)[:, None]
        generated.append(tok)
        if sink is not None:
            lat = seconds_since(ts, dev)
            sink.emit(obs_sinks.make_record(
                "serve_decode", i, {"latency_s": lat, "tokens_per_s": B / lat}))
    dt = seconds_since(t0, dev)
    out.update(decode_ms=dt * 1e3, tok_s=B * N / dt,
               tokens=torch.cat(generated, 1).cpu(),
               length=int(cache["length"]))
    print(f"decode {N} steps: {dt*1e3:.0f} ms ({out['tok_s']:.1f} tok/s)")
    if dev.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if sink is not None:
        sink.close()
        out.update(telemetry_records=sink.emitted, telemetry_path=sink.path)
        print(f"telemetry: {sink.emitted} records -> {sink.path}")
    return out


if __name__ == "__main__":
    main()
