"""Decoder-only LM for the homogeneous stacks: dense (olmo-1b, qwen2.5-14b,
yi-9b, nemotron-4-340b and their kin) and MoE (granite-moe-1b-a400m).

The reference's ``LM`` in PyTorch: layer-stacked leaves ((L, ...) each,
as the reference's vmapped init builds them), a loop over the layers where
the reference scans, tied or separate output head, the cross-entropy
loss plus the MoE's load-balance loss summed over the layers (the
reference's ``total``), and serving: ``init_cache``, ``prefill`` and
``decode_step``.  MLA, recurrent and hybrid stacks and multi-token
prediction raise (``configs.check_ported``, ROADMAP A13), their caches
with them.

Parameters are a dict keyed by the leaves' paths in the reference's tree
("blocks/attn/wq", "embed", ...): sorted, those keys are the reference's
``jax.tree_util.tree_leaves`` order.  Each leaf has the reference's dtype:
norm scales and biases and the MoE router in float32, every other leaf in
the model's dtype; ``param_shapes`` is the :class:`convert.Layout` of
both, whose flat parameters both packages agree on (one tensor where
every leaf has one dtype, a buffer per dtype otherwise).  ``loss`` runs
one model; ``loss_stacked`` runs C cohorts at once, a leading C on every
leaf and on the batch, and returns one loss per cohort
(``core.fl.local_sgd``).

Under ``train.remat`` each layer runs under ``torch.utils.checkpoint``:
its activations are recomputed in the backward pass, the same numbers.

The cache is a dict with the reference's fields: ``k`` and ``v`` (L, B,
C, KV, hd) in the model's dtype, ``kv_pos`` (B, C) int32 and ``length``,
a 0-d int32 tensor on the cache's device.  ``decode_step`` derives the
positions and the ring slot from ``length`` on the device, so it makes no
synchronizing call, and writes k and v into the cache in place, as the
reference's jitted step writes into the cache it is donated.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import convert
from repro_torch.config.base import Config, ModelConfig
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]
Shapes = Dict[str, Tuple[int, ...]]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def block_param_shapes(cfg: ModelConfig) -> Shapes:
    """One layer's leaves by path: norm1, norm2, attn, and mlp or moe."""
    shapes: Shapes = {}
    for norm in ("norm1", "norm2"):
        for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
            shapes[f"{norm}/{k}"] = s
    for k, s in attn.attention_param_shapes(cfg).items():
        shapes[f"attn/{k}"] = s
    if cfg.moe.enabled:
        for k, s in mlp.moe_param_shapes(cfg).items():
            shapes[f"moe/{k}"] = s
    else:
        for k, s in mlp.mlp_param_shapes(cfg).items():
            shapes[f"mlp/{k}"] = s
    return shapes


#: the leaves the reference keeps in float32 whatever the model's dtype:
#: the norms' scales and biases (``make_norm_params``) and the MoE router
FLOAT32_LEAVES = ("final_norm/", "blocks/norm1/", "blocks/norm2/",
                  "blocks/moe/router")


def lm_param_shapes(cfg: ModelConfig) -> convert.Layout:
    """Every leaf of the LM by path, in sorted (leaf) order, with its
    dtype; the layer leaves are stacked (L, ...)."""
    shapes: Shapes = {"embed": (cfg.vocab_size, cfg.d_model)}
    for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
        shapes[f"final_norm/{k}"] = s
    if not cfg.tie_embeddings:
        shapes["head"] = (cfg.d_model, cfg.vocab_size)
    for k, s in block_param_shapes(cfg).items():
        shapes[f"blocks/{k}"] = (cfg.n_layers,) + s
    dt = torch_dtype(cfg)
    return convert.Layout(shapes, {
        k: torch.float32 if k.startswith(FLOAT32_LEAVES) else dt
        for k in shapes})


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the last two axes but one: logits
    (..., B, S, V), labels (..., B, S) -> (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean(dim=(-2, -1))


@dataclass
class LM:
    """Decoder-only language model, dense and MoE families;
    ``models.build_model`` checks the config (``configs.check_ported``)
    before it builds one."""
    config: Config

    def __post_init__(self):
        self.param_shapes = lm_param_shapes(self.cfg)
        self.num_params = self.param_shapes.numel

    @property
    def cfg(self) -> ModelConfig:
        return self.config.model

    @property
    def dtype(self) -> torch.dtype:
        """The model's dtype: its activations' and cache's, and every
        leaf's but those of ``FLOAT32_LEAVES``."""
        return torch_dtype(self.cfg)

    #: the reference's ``LM.loss`` ignores its rng: no fake-quant in the
    #: local steps (the QNN's STE is the cnn's, ``CNNModel``)
    quantizes_training = False

    # -- init ------------------------------------------------------------------

    def init_flat(self, seed: Union[int, torch.Generator] = 0, *,
                  device: DeviceLike = None) -> convert.Flat:
        """The flat parameters (``param_shapes``' layout: the (D,) vector of
        the config's dtype where every leaf has it) from one generator, as
        the reference's ``init`` lays them out: embeddings N(0, 0.02²);
        then layer by layer its attention and MLP (or MoE) matrices
        N(0, 1/fan_in) (``init_attention_params``, ``init_mlp_params``,
        ``init_moe_params``) and its norms (``make_norm_params``, float32);
        the final norm; a separate head.  The draws are the port's own: a
        parity test converts the reference's parameters instead
        (``convert.flat_from_tree``)."""
        cfg, dt = self.cfg, self.dtype
        dev = resolve_device(device)
        gen = make_generator(seed, dev)
        flat = self.param_shapes.empty(device=dev)
        views = convert.unflatten_params(flat, self.param_shapes)

        def fill(prefix, leaves, layer=None):
            for k, v in leaves.items():
                view = views[f"{prefix}/{k}"]
                (view if layer is None else view[layer]).copy_(v)

        views["embed"].copy_(common.embed_init(
            gen, (cfg.vocab_size, cfg.d_model)))
        norm = common.make_norm_params(cfg, cfg.d_model, device=dev)
        for i in range(cfg.n_layers):
            fill("blocks/norm1", norm, i)
            fill("blocks/norm2", norm, i)
            fill("blocks/attn", attn.init_attention_params(gen, cfg, dtype=dt), i)
            if cfg.moe.enabled:
                fill("blocks/moe", mlp.init_moe_params(gen, cfg, dtype=dt), i)
            else:
                fill("blocks/mlp", mlp.init_mlp_params(gen, cfg, dtype=dt), i)
        fill("final_norm", norm)
        if not cfg.tie_embeddings:
            views["head"].copy_(common.dense_init(
                gen, (cfg.d_model, cfg.vocab_size)))
        return flat

    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device: DeviceLike = None) -> Params:
        """:meth:`init_flat`'s leaves by path (views of its buffers)."""
        return convert.unflatten_params(self.init_flat(seed, device=device),
                                        self.param_shapes)

    # -- forward (full sequence) -------------------------------------------------

    def _embed(self, params: Params, tokens: torch.Tensor,
               stacked: bool) -> torch.Tensor:
        table = params["embed"]
        if not stacked:
            return F.embedding(tokens.long(), table)
        # C tables as one (C·V, d) table, cohort c's ids offset by c·V
        C, V, d = table.shape
        offs = torch.arange(C, device=tokens.device) * V
        ids = tokens.long() + offs.reshape(C, *([1] * (tokens.dim() - 1)))
        return F.embedding(ids, table.reshape(C * V, d))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            logits = common.linear(x, params["embed"].transpose(-1, -2))
        else:
            logits = common.linear(x, params["head"])
        return logits.float()

    def _backbone(self, params: Params, tokens: torch.Tensor, *,
                  stacked: bool, remat: bool,
                  store_kv: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                              None]] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """tokens (B, S) or (C, B, S) -> (the final normed hidden states,
        the MoE's load-balance loss summed over the layers in layer order,
        () or (C,), or None for a dense stack).  ``store_kv(i, k, v)``,
        where given, takes layer i's rope'd k and v (B, S, KV, hd) as the
        layers run (prefill fills its cache so)."""
        cfg = self.cfg
        B, S = tokens.shape[-2:]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x = self._embed(params, tokens, stacked)
        # one unbind a leaf: its backward stacks the layers' gradients in
        # one write, where a select a layer would zero-fill the whole leaf
        # and add into it once a layer
        blocks = {k[len("blocks/"):]: v.unbind(1 if stacked else 0)
                  for k, v in params.items() if k.startswith("blocks/")}
        aux = None
        for i in range(cfg.n_layers):
            layer = {k: v[i] for k, v in blocks.items()}
            if remat and torch.is_grad_enabled():
                x, aux_l = checkpoint(self._block, layer, x, positions,
                                      use_reentrant=False)
            else:
                x, aux_l = self._block(layer, x, positions,
                                       None if store_kv is None
                                       else functools.partial(store_kv, i))
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        return common.apply_norm(x, _sub(params, "final_norm"), cfg), aux

    def _block(self, layer: Params, x: torch.Tensor, positions: torch.Tensor,
               store_kv: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.cfg
        h = common.apply_norm(x, _sub(layer, "norm1"), cfg)
        mix, (k, v) = attn.self_attention(_sub(layer, "attn"), h, positions,
                                          cfg, window=cfg.attention_window)
        if store_kv is not None:
            store_kv(k, v)
        del k, v                # not held through the MLP
        return self._ff_residual(layer, x + mix.to(x.dtype))

    def _ff_residual(self, layer: Params, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The norm2 branch: x plus the MLP's (or MoE's) output, and the
        MoE's load-balance loss (None for the MLP)."""
        cfg = self.cfg
        h = common.apply_norm(x, _sub(layer, "norm2"), cfg)
        if cfg.moe.enabled:
            ff, aux = mlp.moe(_sub(layer, "moe"), h, cfg)
        else:
            ff, aux = mlp.mlp(_sub(layer, "mlp"), h, cfg), None
        return x + ff.to(x.dtype), aux

    # -- training loss -------------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], rng=None,
             *, remat: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One model's loss over the batch's tokens and labels (B, S): the
        mean cross-entropy plus the MoE's load-balance loss (the
        reference's ``total``), with both in the metrics; ``rng`` is
        ignored, as the reference's."""
        remat = self.config.train.remat if remat is None else remat
        x, aux = self._backbone(params, batch["tokens"], stacked=False,
                                remat=remat)
        ce = _cross_entropy(self._logits(params, x), batch["labels"])
        if aux is None:
            return ce, {"ce": ce, "aux": torch.zeros((), device=ce.device)}
        return ce + aux, {"ce": ce, "aux": aux}

    def loss_stacked(self, params: Params, batch: Dict[str, torch.Tensor], *,
                     remat: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """C cohorts at once: leaves (C, ...), tokens and labels (C, B, S).
        Returns each cohort's loss (:meth:`loss`'s) and token accuracy,
        (C,) each (the accuracy computed without gradient)."""
        remat = self.config.train.remat if remat is None else remat
        x, aux = self._backbone(params, batch["tokens"], stacked=True,
                                remat=remat)
        logits = self._logits(params, x)
        ce = _cross_entropy(logits, batch["labels"])
        with torch.no_grad():
            hit = logits.argmax(-1) == batch["labels"].long()
            acc = hit.float().mean(dim=(-2, -1))
        return (ce if aux is None else ce + aux), acc

    # -- serving ---------------------------------------------------------------

    def cache_capacity(self, seq_len: int) -> int:
        """Slots a layer's cache holds for a ``seq_len`` context: the
        window of a sliding-window model, else the context."""
        w = self.cfg.attention_window
        return min(w, seq_len) if w > 0 else seq_len

    def init_cache(self, batch: int, seq_len: int, *,
                   device: DeviceLike = None) -> Cache:
        """Empty cache sized for a ``seq_len`` context."""
        cfg = self.cfg
        dev = resolve_device(device)
        C = self.cache_capacity(seq_len)
        shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=dev),
                "v": torch.zeros(shape, dtype=self.dtype, device=dev),
                "kv_pos": torch.full((batch, C), -1, dtype=torch.int32,
                                     device=dev),
                "length": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor, *,
                max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        """Process a prompt (B, S); return (the last position's logits (B, V)
        in float32, the filled cache).

        Logits are computed for the last position only, as the reference's.
        ``max_len`` sizes the cache for the decode steps to come (default
        the prompt; prompt + new tokens decodes without overwriting the
        earliest positions).  Each layer's k and v land in the cache as the
        layers run: the prompt's last min(C, S) positions in slots 0, 1,
        ..., zeros past the prompt; a window keeps its last C positions,
        and the ring's slot of position p is p % C, so that crop needs
        S % C == 0."""
        B, S = tokens.shape
        C = self.cache_capacity(max(max_len, S))
        if C < S and S % C:
            raise ValueError(
                f"windowed prefill->decode needs prompt length ({S}) to be "
                f"a multiple of the window ({C})")
        cache = self.init_cache(B, max(max_len, S), device=tokens.device)
        n = min(C, S)           # the prompt's last n positions fill slots 0..n-1

        def store(i, k, v):
            cache["k"][i, :, :n].copy_(k[:, S - n:])
            cache["v"][i, :, :n].copy_(v[:, S - n:])

        h, _ = self._backbone(params, tokens, stacked=False, remat=False,
                              store_kv=store)
        logits = self._logits(params, h[:, -1:])
        cache["kv_pos"][:, :n] = torch.arange(S - n, S, dtype=torch.int32,
                                              device=tokens.device)
        cache["length"].fill_(S)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1): one decode step against the cache.  Returns (the
        logits (B, 1, V) in float32, the cache after the step).  The cache's
        k and v are written in place, and the returned cache shares them:
        the one passed in is spent."""
        cfg = self.cfg
        B = tokens.shape[0]
        length = cache["length"]
        C = cache["k"].shape[2]
        positions = length.expand(B, 1)
        slot = torch.remainder(length, C).long().reshape(1)
        kv_pos = cache["kv_pos"]
        x = self._embed(params, tokens, False)
        blocks = {k[len("blocks/"):]: v.unbind(0)
                  for k, v in params.items() if k.startswith("blocks/")}
        for i in range(cfg.n_layers):
            layer = {k: v[i] for k, v in blocks.items()}
            h = common.apply_norm(x, _sub(layer, "norm1"), cfg)
            mix = attn.decode_self_attention(
                _sub(layer, "attn"), h, positions, cfg,
                cache_k=cache["k"][i], cache_v=cache["v"][i], kv_pos=kv_pos,
                write_slot=slot, window=cfg.attention_window)
            x, _ = self._ff_residual(layer, x + mix.to(x.dtype))
        x = common.apply_norm(x, _sub(params, "final_norm"), cfg)
        new_kv_pos = kv_pos.index_copy(1, slot, positions)
        return self._logits(params, x), {
            "k": cache["k"], "v": cache["v"], "kv_pos": new_kv_pos,
            "length": length + 1}


def _sub(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix/``, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}
