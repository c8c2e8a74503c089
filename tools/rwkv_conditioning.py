"""How far float32 lets two correct runs of the port's reduced LMs part, at
``chip_smoke.py``'s card-against-CPU settings, on the CPU alone.

Two measurements, each against the port's own float32 run:

* **Serving** (``chip_smoke.serve_reference_check``'s inputs: parameters
  ``init(3)``, a 2 x 32 prompt and 4 decode steps from a generator seeded
  7, a cache of 40; olmo-1b's (c) a window of 16).  Three draws of noise
  of one float32 ulp on every parameter; the largest move of the logits or
  of a cache entry, as a share of its largest value.  A run whose sums
  are ordered otherwise (the card's) lands about as far: the share is what
  a bound on card against CPU has to allow.  For rwkv6-7b also the
  smallest nonzero variance under the per-head group norm (eps 1e-5).
* **The round** (``chip_smoke.lm_reference_phase``'s: C = 4, I = 2, 16 x
  32 tokens, int at 8 bits, packets [1, 0, 1, 1]).  The same round with
  every product (``models.common.linear``) taken in float64 and rounded
  once, a second float32 order of the same function; the largest
  parameter difference in uplink code steps (1/128), the share equal and
  the losses.

Run: ``PYTHONPATH=src python tools/rwkv_conditioning.py``; about a minute.
"""
from __future__ import annotations

import torch

from repro_torch import convert
from repro_torch.config import apply_overrides
from repro_torch.configs import get_config, reduced
from repro_torch.core.fl import RoundNoise, make_fl_round
from repro_torch.models import build_model, common, rwkv

F32 = ("model.dtype=float32",)
LM_SMALL = ("model.n_layers=2", "model.d_model=128", "model.n_heads=4",
            "model.n_kv_heads=4", "model.d_ff=256", "model.vocab_size=512",
            "model.dtype=float32", "train.seq_len=32")
SERVE = {
    "olmo-1b (b)": (get_config("olmo-1b"), LM_SMALL, 40),
    "olmo-1b (c)": (get_config("olmo-1b"),
                    LM_SMALL + ("model.attention_window=16",), 0),
    "qwen2.5-14b": (reduced(get_config("qwen2.5-14b")), F32, 40),
    "granite-moe-1b-a400m": (reduced(get_config("granite-moe-1b-a400m")),
                             F32, 40),
    "rwkv6-7b 1 layer": (reduced(get_config("rwkv6-7b")),
                         F32 + ("model.n_layers=1",), 40),
    "rwkv6-7b 2 layers": (reduced(get_config("rwkv6-7b")), F32, 40),
    "recurrentgemma-2b 3 layers": (reduced(get_config("recurrentgemma-2b")),
                                   F32 + ("model.n_layers=3",), 40),
}
ROUNDS = [("rwkv6-7b", 0.5, ()), ("rwkv6-7b", 0.01, ()),
          ("recurrentgemma-2b", 0.5, ("model.n_layers=3",))]


class _Variances:
    """``rwkv``'s torch, recording what the group norm's ``rsqrt`` is given
    (the variance plus eps)."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def rsqrt(self, t):
        self.seen.append(t.flatten() - 1e-5)
        return torch.rsqrt(t)


def _serve(model, params, toks, steps, max_len):
    logits, cache = model.prefill(params, toks, max_len=max_len)
    out = [logits]
    for tok in steps:
        logits, cache = model.decode_step(params, cache, tok)
        out.append(logits)
    return out + [cache[k] for k in sorted(cache)
                  if cache[k].is_floating_point()]


def serving_spread(base, overrides, max_len):
    """(largest share moved by a float32 ulp on every parameter, smallest
    nonzero group-norm variance or None)."""
    cfg = apply_overrides(base, overrides)
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.model.vocab_size, (2, 32), generator=gen,
                         dtype=torch.int32)
    steps = torch.randint(0, cfg.model.vocab_size, (4, 2, 1), generator=gen,
                          dtype=torch.int32)
    spy = _Variances()
    rwkv.torch = spy
    try:
        want = _serve(model, params, toks, steps, max_len)
    finally:
        rwkv.torch = torch
    var = torch.cat(spy.seen) if spy.seen else None
    noise = torch.Generator().manual_seed(11)
    worst = 0.0
    for _ in range(3):
        moved = {k: v * (1 + torch.randint(-1, 2, v.shape, generator=noise)
                         .to(v.dtype) * 2.0 ** -23) for k, v in params.items()}
        got = _serve(model, moved, toks, steps, max_len)
        worst = max(worst, max(float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(got, want)))
    return worst, None if var is None else float(var[var > 0].min())


def _linear64(x, w):
    if w.dim() == 2:
        return (x.double() @ w.double()).to(x.dtype)
    C = w.shape[0]
    out = torch.bmm(x.reshape(C, -1, x.shape[-1]).double(), w.double())
    return out.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])


def round_parting(arch, lr, extra):
    """The round in the port's float32 order and in float64 products."""
    C, I, B = 4, 2, 16
    cfg = apply_overrides(reduced(get_config(arch)), (
        f"fl.local_iters={I}", f"fl.learning_rate={lr}",
        f"train.global_batch={B}", "channel.error_prob=0.3",
        "train.seq_len=32") + F32 + extra)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(7)
    params = model.init_flat(3, device="cpu")
    tok = torch.randint(0, cfg.model.vocab_size, (B, 32), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    noise = RoundNoise(None, torch.rand((C, model.num_params), generator=gen),
                       torch.tensor([1.0, 0.0, 1.0, 1.0]))
    out, linear = [], common.linear
    for product in (linear, _linear64):
        common.linear = product
        try:
            fn = make_fl_round(model, cfg, (C,), collective="int",
                               device="cpu")
            new, m = fn(convert.map_buffers(torch.clone, params), batch,
                        noise=noise)
        finally:
            common.linear = linear
        out.append((torch.cat([b.float() for b in convert.buffers(new)]),
                    float(m["loss"])))
    diff = (out[1][0] - out[0][0]).abs()
    return {"code_steps": float(diff.max()) * 128,
            "equal": float((diff == 0).float().mean()),
            "within_1e-5": float((diff <= 1e-5).float().mean()),
            "loss": (out[0][1], out[1][1])}


def main():
    torch.manual_seed(0)
    for name, (base, overrides, max_len) in SERVE.items():
        share, var = serving_spread(base, overrides, max_len)
        print(f"serving {name}: a float32 ulp moves the outputs by "
              f"{share:.3g} of their largest"
              + ("" if var is None else
                 f"; smallest nonzero group-norm variance {var:.3g}"))
    for arch, lr, extra in ROUNDS:
        r = round_parting(arch, lr, extra)
        print(f"round {arch} {' '.join(extra)} lr {lr:g}: float64 products "
              f"part it by {r['code_steps']:.3g} code steps, "
              f"{r['equal']:.6f} equal, {r['within_1e-5']:.6f} within 1e-5, "
              f"loss {r['loss'][0]:.6f} vs {r['loss'][1]:.6f}")


if __name__ == "__main__":
    main()
