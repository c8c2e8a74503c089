"""Batched serving demo on the PyTorch port: prefill a batch of prompts,
then greedy-decode, the same flow as ``examples/serve_demo.py``.

Serves a reduced qwen2.5-14b by default, as the reference's demo: its
rmsnorm scales in float32 beside bfloat16 weights (a dtype per leaf,
``convert.Layout``).  Runs on the CUDA device by default; ``--device
cpu`` runs on the CPU.

  PYTHONPATH=src python examples/torch_serve_demo.py [--batch 4 --prompt-len 32 --new-tokens 16] [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import (make_generator, resolve_device,
                                seconds_since)
from repro_torch.launch.inputs import random_tokens
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device when omitted")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(0, device=dev)
    print(f"serving {cfg.model.name}: {model.num_params/1e6:.1f}M "
          f"params, batch={args.batch}")

    prompts = random_tokens((args.batch, args.prompt_len),
                            cfg.model.vocab_size, make_generator(1, dev))
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompts)
    t_prefill = seconds_since(t0, dev)

    tokens = logits.reshape(args.batch, -1).argmax(-1)[:, None]
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        tokens = logits[:, -1].argmax(-1)[:, None]
        generated.append(tokens)
    t_decode = seconds_since(t0, dev)

    out = torch.cat(generated, dim=1)
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in "
          f"{t_prefill*1e3:.1f} ms")
    print(f"decode:  {args.new_tokens} steps in {t_decode*1e3:.1f} ms "
          f"({t_decode/args.new_tokens*1e3:.1f} ms/step)")
    print(f"generated token ids (batch 0): {out[0].tolist()}")
    print(f"cache length after decode: {int(cache['length'])} "
          f"(= prompt {args.prompt_len} + {args.new_tokens} decoded)")


if __name__ == "__main__":
    main()
