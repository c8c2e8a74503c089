"""Decoder-only LM: dense (olmo-1b, qwen2.5-14b, yi-9b, nemotron-4-340b
and their kin), vlm (chameleon-34b: a dense stack over VQ token ids), MoE
(granite-moe-1b-a400m; deepseek-v3-671b with MLA, a shared expert and
multi-token prediction), RWKV-6 (rwkv6-7b, family ssm) and the Griffin
hybrid (recurrentgemma-2b).

The reference's ``LM`` in PyTorch: a homogeneous stack's leaves
layer-stacked ((L, ...) each, as the reference's vmapped init builds them)
and run by a loop over the layers where the reference scans; the hybrid's
layers a list, each its own leaves (recurrent layers an RG-LRU block and an
MLP, local-attention layers MQA over ``local_window`` and an MLP, along
``recurrent.block_pattern``); tied or separate output head; the
cross-entropy loss plus the MoE's load-balance loss summed over the layers
(the reference's ``total``) and, with ``mtp_depth``, 0.3 times the
multi-token prediction's cross-entropy (``mtp/...`` leaves: the next
token's embedding beside the final hidden state, projected, through one
more MLA + MoE block); and serving: ``init_cache``, ``prefill`` and
``decode_step``.  An MLA stack (``models.mla``) caches the latent.

Parameters are a dict keyed by the leaves' paths in the reference's tree
("blocks/attn/wq", "blocks/3/rec/w_a", "embed", ...); in leaf order
(``convert.leaf_order``: a list's children by index) those keys are the
reference's ``jax.tree_util.tree_leaves`` order.  Each leaf has the
reference's dtype: the model's, or float32 where the reference's init
makes it so (``block_leaves``); ``param_shapes`` is the
:class:`convert.Layout` of both, whose flat parameters both packages agree
on (one tensor where every leaf has one dtype, a buffer per dtype
otherwise).  ``loss`` runs one model; ``loss_stacked`` runs C cohorts at
once, a leading C on every leaf and on the batch, and returns one loss per
cohort (``core.fl.local_sgd``).

Under ``train.remat`` each layer runs under ``torch.utils.checkpoint``:
its activations are recomputed in the backward pass, the same numbers.

**Tensor parallelism** (the dense and vlm families: ``tensor_parallel``).
A model placed on a rank of the distributed round
(``sharding.placement.place_model``) holds its blocks of the leaves
(``param_shapes`` the local layout) and reduces over ``tp``'s model group:
the embedding sharded over its vocabulary looks up the tokens in its
block, zeros the rest and sums (g); attention and the MLP run their heads'
and ff columns' blocks (``attention``, ``mlp``); the logits of a sharded
head (or tied embedding) are the block's vocabulary, and the
cross-entropy and the accuracy reduce over the model group (the max, the
sum of exponentials and the target's logit; the first index of the
largest logit).  The same code runs one process with ``tp`` None.

The cache is a dict of tensors: the attention layers' ``k`` and ``v``
(L_att, B, C, KV, hd) in the model's dtype (an MLA stack's ``latent``
(L, B, C, r + d_rope) instead) and one ``kv_pos`` (B, C) int32; RWKV-6's
``S``, ``x_tm`` and ``x_cm``, the RG-LRU's ``h`` and ``conv``
(``init_cache``); and ``length``, a 0-d int32 tensor on the
cache's device.  ``decode_step`` derives the positions and the ring slot
from ``length`` on the device, so it makes no synchronizing call, and
writes k, v and the states into the cache in place, as the reference's
jitted step writes into the cache it is donated.  An RWKV-6 stack's
``prefill`` runs the prompt PREFILL_CHUNK tokens at a time through the
same loop, each chunk from the states the last one left, so that its
memory does not grow with the prompt.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import convert
from repro_torch.config.base import Config, ModelConfig
from repro_torch.core import comm as comm_mod
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, griffin, mla, mlp, rwkv

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]

#: tokens an RWKV-6 stack's prefill runs through its layers at a time: the
#: scan holds a (H, hd, hd) float32 state a token of its chunk (1 MiB at
#: rwkv6-7b's widths), where the whole prompt at once would hold them all
PREFILL_CHUNK = 512


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


#: the block kinds that hold an attention layer (and a k/v cache)
ATTENTION = ("attention", "local_attention")


def block_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """The reference's kind of layer ``layer_idx``: "rwkv6" throughout an
    RWKV-6 stack, "recurrent" or "local_attention" along a hybrid's block
    pattern, else "attention"."""
    if cfg.recurrent.kind == "rwkv6":
        return "rwkv6"
    if cfg.family == "hybrid" and cfg.recurrent.block_pattern:
        pat = cfg.recurrent.block_pattern
        return ("recurrent" if pat[layer_idx % len(pat)] == "recurrent"
                else "local_attention")
    return "attention"


def block_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.local_window if kind == "local_attention" else cfg.attention_window


def block_leaves(cfg: ModelConfig, kind: str
                 ) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One layer's leaves by path -> (shape, whether the reference keeps it
    in float32 whatever the model's dtype): the norms' scales and biases
    (``make_norm_params``), the MoE router, RWKV-6's ``rwkv.FLOAT32`` and
    the RG-LRU's ``griffin.FLOAT32``, as the reference's inits make them.
    An RWKV-6 layer holds its norms and "rwkv"; any other its norms, "rec"
    (recurrent), "mla" (an attention layer where ``cfg.mla.enabled``; its
    norms' scales float32) or "attn", and "mlp" or "moe"."""
    out = {}
    for norm in ("norm1", "norm2"):
        for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
            out[f"{norm}/{k}"] = (s, True)
    if kind == "rwkv6":
        for k, s in rwkv.rwkv_param_shapes(cfg).items():
            out[f"rwkv/{k}"] = (s, k in rwkv.FLOAT32)
        return out
    if kind == "recurrent":
        for k, s in griffin.recurrent_param_shapes(cfg).items():
            out[f"rec/{k}"] = (s, k in griffin.FLOAT32)
    elif cfg.mla.enabled:
        for k, s in mla.mla_param_shapes(cfg).items():
            out[f"mla/{k}"] = (s, k in mla.FLOAT32)
    else:
        for k, s in attn.attention_param_shapes(cfg).items():
            out[f"attn/{k}"] = (s, False)
    if cfg.moe.enabled:
        for k, s in mlp.moe_param_shapes(cfg).items():
            out[f"moe/{k}"] = (s, k == "router")
    else:
        for k, s in mlp.mlp_param_shapes(cfg).items():
            out[f"mlp/{k}"] = (s, False)
    return out


def homogeneous(cfg: ModelConfig) -> bool:
    """Layer-stacked (L, ...) leaves under "blocks/", as the reference's
    vmapped init; a hybrid holds a list, each layer's leaves under
    "blocks/{i}/"."""
    return cfg.family != "hybrid"


def lm_param_shapes(cfg: ModelConfig) -> convert.Layout:
    """Every leaf of the LM by path, in leaf order, with its dtype."""
    leaves = {"embed": ((cfg.vocab_size, cfg.d_model), False)}
    for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
        leaves[f"final_norm/{k}"] = (s, True)
    if not cfg.tie_embeddings:
        leaves["head"] = ((cfg.d_model, cfg.vocab_size), False)
    if homogeneous(cfg):
        for k, (s, f32) in block_leaves(cfg, block_kind(cfg, 0)).items():
            leaves[f"blocks/{k}"] = ((cfg.n_layers,) + s, f32)
    else:
        for i in range(cfg.n_layers):
            for k, v in block_leaves(cfg, block_kind(cfg, i)).items():
                leaves[f"blocks/{i}/{k}"] = v
    if cfg.mtp_depth > 0:
        leaves["mtp/proj"] = ((2 * cfg.d_model, cfg.d_model), False)
        for k, v in block_leaves(cfg, "attention").items():
            leaves[f"mtp/block/{k}"] = v
        for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
            leaves[f"mtp/norm/{k}"] = (s, True)
    dt = torch_dtype(cfg)
    return convert.Layout({k: s for k, (s, _) in leaves.items()},
                          {k: torch.float32 if f32 else dt
                           for k, (_, f32) in leaves.items()})


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 stacked: bool) -> torch.Tensor:
    """Rows of the embedding table (V, d) at tokens (..., S); stacked, C
    tables (C, V, d) and tokens (C, ...), cohort c's ids into table c."""
    if not stacked:
        return F.embedding(tokens.long(), table)
    # C tables as one (C·V, d) table, cohort c's ids offset by c·V
    C, V, d = table.shape
    offs = torch.arange(C, device=tokens.device) * V
    ids = tokens.long() + offs.reshape(C, *([1] * (tokens.dim() - 1)))
    return F.embedding(ids, table.reshape(C * V, d))


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the last two axes but one: logits
    (..., B, S, V), labels (..., B, S) -> (...)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -ll.mean(dim=(-2, -1))


def _vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  tp) -> torch.Tensor:
    """:func:`_cross_entropy` of logits whose last axis is model rank m's
    block of the vocabulary, [m·Vl, (m+1)·Vl): the max, the sum of
    exponentials and the target's logit reduced over the model group (the
    last two through g, so each rank's gradient is its block's softmax
    minus its block of the one-hot)."""
    logits = logits.float()
    Vl = logits.shape[-1]
    top = tp.model_all_reduce(logits.detach().amax(-1, keepdim=True), "max")
    shifted = logits - top
    sumexp = comm_mod.reduce_from_model(torch.exp(shifted).sum(-1), tp)
    local = labels.long() - tp.model_index * Vl
    inside = (local >= 0) & (local < Vl)
    picked = torch.gather(shifted, -1,
                          torch.where(inside, local, 0)[..., None])[..., 0]
    target = comm_mod.reduce_from_model(picked.masked_fill(~inside, 0), tp)
    return -(target - torch.log(sumexp)).mean(dim=(-2, -1))


@dataclass
class LM:
    """Decoder-only language model of every family but the cnn and the
    encoder-decoder: dense, vlm, MoE (with MLA and multi-token
    prediction), RWKV-6 and the Griffin hybrid."""
    config: Config

    def __post_init__(self):
        self.param_shapes = lm_param_shapes(self.cfg)
        self.num_params = self.param_shapes.numel
        self.kinds = tuple(block_kind(self.cfg, i)
                           for i in range(self.cfg.n_layers))
        # each layer's index in its cache stack: k/v, the RWKV-6 state or
        # the RG-LRU state
        seen: Dict[str, int] = {}
        self._slot = []
        for kind in self.kinds:
            group = "kv" if kind in ATTENTION else kind
            self._slot.append(seen.get(group, 0))
            seen[group] = self._slot[-1] + 1

    @property
    def cfg(self) -> ModelConfig:
        return self.config.model

    @property
    def dtype(self) -> torch.dtype:
        """The model's dtype: its activations' and cache's, and every
        leaf's that the reference does not keep in float32
        (``block_leaves``)."""
        return torch_dtype(self.cfg)

    #: the reference's ``LM.loss`` ignores its rng: no fake-quant in the
    #: local steps (the QNN's STE is the cnn's, ``CNNModel``)
    quantizes_training = False
    #: where placed on a rank (``sharding.placement``): its Placement and
    #: the ``core.comm.Comm`` of its model group
    placement = None
    tp = None

    @property
    def tensor_parallel(self) -> bool:
        """Whether the forward runs split over a model group: the dense
        decoders (MoE, MLA, RWKV-6 and Griffin wait for ROADMAP A.5)."""
        return self.cfg.family in ("dense", "vlm")

    # -- init ------------------------------------------------------------------

    def init_flat(self, seed: Union[int, torch.Generator] = 0, *,
                  device: DeviceLike = None) -> convert.Flat:
        """The flat parameters (``param_shapes``' layout: the (D,) vector of
        the config's dtype where every leaf has it) from one generator, as
        the reference's ``init`` lays them out: embeddings N(0, 0.02²);
        then layer by layer its mixer's matrices N(0, 1/fan_in) (attention,
        MLA, RWKV-6 or RG-LRU, with their float32 constants) and its MLP's
        (or MoE's), and its norms (``make_norm_params``, float32); the final
        norm; a separate head; the multi-token prediction's projection,
        block and norm.  The draws are the port's own: a parity test
        converts the reference's parameters instead
        (``convert.flat_from_tree``)."""
        cfg, dt = self.cfg, self.dtype
        dev = resolve_device(device)
        gen = make_generator(seed, dev)
        flat = self.param_shapes.empty(device=dev)
        views = convert.unflatten_params(flat, self.param_shapes)

        def put(path, v, layer=None):
            # a placed model keeps its block of each leaf drawn whole
            if self.placement is not None:
                v = self.placement.block(path, v, layer=layer is not None)
            (views[path] if layer is None else views[path][layer]).copy_(v)

        def fill(prefix, leaves, layer=None):
            pairs = leaves.items() if isinstance(leaves, dict) else leaves
            for k, v in pairs:
                put(f"{prefix}/{k}", v, layer)
                del v       # freed before a generator draws the next leaf

        put("embed", common.embed_init(gen, (cfg.vocab_size, cfg.d_model)))
        norm = common.make_norm_params(cfg, cfg.d_model, device=dev)

        def fill_block(pre, kind, at=None):
            fill(f"{pre}/norm1", norm, at)
            fill(f"{pre}/norm2", norm, at)
            if kind == "rwkv6":
                fill(f"{pre}/rwkv", rwkv.init_rwkv_params(gen, cfg, dtype=dt),
                     at)
                return
            if kind == "recurrent":
                fill(f"{pre}/rec", griffin.init_recurrent_params(
                    gen, cfg, dtype=dt), at)
            elif cfg.mla.enabled:
                fill(f"{pre}/mla", mla.init_mla_params(gen, cfg, dtype=dt), at)
            else:
                fill(f"{pre}/attn", attn.init_attention_params(
                    gen, cfg, dtype=dt), at)
            if cfg.moe.enabled:
                fill(f"{pre}/moe", mlp.iter_moe_params(gen, cfg, dtype=dt), at)
            else:
                fill(f"{pre}/mlp", mlp.init_mlp_params(gen, cfg, dtype=dt), at)

        for i, kind in enumerate(self.kinds):
            if homogeneous(cfg):
                fill_block("blocks", kind, i)
            else:
                fill_block(f"blocks/{i}", kind)
        fill("final_norm", norm)
        if not cfg.tie_embeddings:
            put("head", common.dense_init(gen, (cfg.d_model, cfg.vocab_size)))
        if cfg.mtp_depth > 0:
            put("mtp/proj", common.dense_init(gen, (2 * cfg.d_model,
                                                    cfg.d_model)))
            fill_block("mtp/block", "attention")
            fill("mtp/norm", norm)
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
        Vl = table.shape[-2]
        if self.tp is None or Vl == self.cfg.vocab_size:
            return embed_tokens(table, tokens, stacked)
        # this rank's block of the vocabulary: its tokens' rows, zeros for
        # the others, summed over the model group
        local = tokens.long() - self.tp.model_index * Vl
        inside = (local >= 0) & (local < Vl)
        rows = embed_tokens(table, torch.where(inside, local, 0), stacked)
        return comm_mod.reduce_from_model(
            rows.masked_fill(~inside[..., None], 0), self.tp)

    def _vocab_sharded(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s last axis is one model rank's block of the
        vocabulary (a head's, the logits')."""
        return self.tp is not None and t.shape[-1] < self.cfg.vocab_size

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """The logits in float32: under tensor parallelism with a sharded
        head (or tied embedding), this rank's block of the vocabulary."""
        w = (params["embed"].transpose(-1, -2) if self.cfg.tie_embeddings
             else params["head"])
        if self._vocab_sharded(w):
            x32 = common.column_input(x, self.tp)
            return common.column_linear(x32, w).float()
        return common.linear(x, w).float()

    def _ce(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if self._vocab_sharded(logits):
            return _vocab_parallel_cross_entropy(logits, labels, self.tp)
        return _cross_entropy(logits, labels)

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The vocabulary index of the largest logit (the first of equals),
        over the model group where the logits are a block of it."""
        if not self._vocab_sharded(logits):
            return logits.argmax(-1)
        Vl = logits.shape[-1]
        mx, arg = logits.max(-1)
        top = self.tp.model_all_reduce(mx, "max")
        cand = torch.where(mx == top, arg + self.tp.model_index * Vl,
                           self.cfg.vocab_size)
        return self.tp.model_all_reduce(cand, "min")

    def _layers(self, params: Params, stacked: bool) -> List[Params]:
        """Each layer's leaves, keyed by their path below the layer.  A
        stacked leaf is unbound once: its backward stacks the layers'
        gradients in one write, where a select a layer would zero-fill the
        whole leaf and add into it once a layer."""
        if homogeneous(self.cfg):
            blocks = {k[len("blocks/"):]: v.unbind(1 if stacked else 0)
                      for k, v in params.items() if k.startswith("blocks/")}
            return [{k: v[i] for k, v in blocks.items()}
                    for i in range(self.cfg.n_layers)]
        out: List[Params] = [{} for _ in range(self.cfg.n_layers)]
        for k, v in params.items():
            if k.startswith("blocks/"):
                i, rest = k[len("blocks/"):].split("/", 1)
                out[int(i)][rest] = v
        return out

    def _backbone(self, params: Params, tokens: torch.Tensor, *,
                  stacked: bool, remat: bool,
                  store: Optional[Callable[[int, Any], None]] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """tokens (B, S) or (C, B, S) -> (the final normed hidden states,
        the MoE's load-balance loss summed over the layers in layer order,
        () or (C,), or None without a MoE).  Each layer starts from an
        empty state (zeros), as the reference's full-sequence blocks do.
        ``store(i, entry)``, where given, takes layer i's cache entry as
        the layers run (prefill fills its cache so): the rope'd (k, v)
        (B, S, KV, hd) of an attention layer (an MLA layer's latent
        entries (B, S, r + d_rope)), the final state of a recurrent
        one."""
        cfg = self.cfg
        B, S = tokens.shape[-2:]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        x = self._embed(params, tokens, stacked)
        aux = None
        for i, (kind, layer) in enumerate(zip(self.kinds,
                                              self._layers(params, stacked))):
            if remat and torch.is_grad_enabled():
                x, aux_l = checkpoint(self._block, kind, layer, x, positions,
                                      use_reentrant=False)
            else:
                x, aux_l = self._block(kind, layer, x, positions,
                                       None if store is None
                                       else functools.partial(store, i))
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        return common.apply_norm(x, _sub(params, "final_norm"), cfg), aux

    def _block(self, kind: str, layer: Params, x: torch.Tensor,
               positions: torch.Tensor, store: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One full-sequence layer (the reference's ``apply_block_full``)."""
        cfg = self.cfg
        lead = x.shape[:-2]
        if kind == "rwkv6":
            x, state = rwkv.rwkv_block(
                _sub(layer, "rwkv"), x, _sub(layer, "norm1"),
                _sub(layer, "norm2"),
                rwkv.init_rwkv_state(lead, cfg, x.dtype, x.device), cfg)
            if store is not None:
                store(state)
            return x, None
        h = common.apply_norm(x, _sub(layer, "norm1"), cfg)
        if kind == "recurrent":
            mix, entry = griffin.recurrent_block(
                _sub(layer, "rec"), h,
                griffin.init_recurrent_state(lead, cfg, x.dtype, x.device), cfg)
        elif cfg.mla.enabled:
            mix, entry = mla.mla_attention(_sub(layer, "mla"), h, positions,
                                           cfg, window=block_window(cfg, kind))
        else:
            mix, entry = attn.self_attention(_sub(layer, "attn"), h, positions,
                                             cfg, window=block_window(cfg, kind),
                                             tp=self.tp)
        if store is not None:
            store(entry)
        del entry               # not held through the MLP
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
            ff, aux = mlp.mlp(_sub(layer, "mlp"), h, cfg, self.tp), None
        return x + ff.to(x.dtype), aux

    # -- training loss -------------------------------------------------------------

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], rng=None,
             *, remat: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One model's loss over the batch's tokens and labels (B, S): the
        mean cross-entropy plus the MoE's load-balance loss (the
        reference's ``total``) plus, with ``mtp_depth``, 0.3 times the
        multi-token prediction's (:meth:`_mtp_ce`), each in the metrics;
        ``rng`` is ignored, as the reference's."""
        remat = self.config.train.remat if remat is None else remat
        x, aux = self._backbone(params, batch["tokens"], stacked=False,
                                remat=remat)
        ce = self._ce(self._logits(params, x), batch["labels"])
        if aux is None:
            total, aux = ce, torch.zeros((), device=ce.device)
        else:
            total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if self.cfg.mtp_depth > 0:
            mtp_ce = self._mtp_ce(params, x, batch["labels"], stacked=False)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

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
        total = self._ce(logits, batch["labels"])
        with torch.no_grad():
            hit = self._argmax(logits) == batch["labels"].long()
            acc = hit.float().mean(dim=(-2, -1))
        del logits
        if aux is not None:
            total = total + aux
        if self.cfg.mtp_depth > 0:
            total = total + 0.3 * self._mtp_ce(params, x, batch["labels"],
                                               stacked=True)
        return total, acc

    def _mtp_ce(self, params: Params, h_final: torch.Tensor,
                labels: torch.Tensor, stacked: bool) -> torch.Tensor:
        """The multi-token prediction's cross-entropy: position t predicts
        token t + 2 from its final hidden state and the next token's
        embedding (the shared table), concatenated, projected by
        "mtp/proj", through one attention block ("mtp/block") and a norm
        ("mtp/norm"), then the shared head; the labels shifted by one, the
        last repeated.  The block's MoE load-balance loss is discarded, as
        the reference discards it."""
        emb_next = self._embed(params, labels, stacked)
        h = common.linear(torch.cat([h_final.to(emb_next.dtype), emb_next],
                                    -1), params["mtp/proj"])
        B, S = labels.shape[-2:]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=labels.device).expand(B, S)
        h, _ = self._block("attention", _sub(params, "mtp/block"), h,
                           positions)
        h = common.apply_norm(h, _sub(params, "mtp/norm"), self.cfg)
        labels2 = torch.cat([labels[..., 1:], labels[..., -1:]], -1)
        return self._ce(self._logits(params, h), labels2)

    # -- serving ---------------------------------------------------------------

    def cache_capacity(self, seq_len: int) -> int:
        """Slots an attention layer's cache holds for a ``seq_len``
        context: its window (a hybrid's local window, a sliding-window
        model's), else the context."""
        kind = next((k for k in self.kinds if k in ATTENTION), "attention")
        w = block_window(self.cfg, kind)
        return min(w, seq_len) if w > 0 else seq_len

    def init_cache(self, batch: int, seq_len: int, *,
                   device: DeviceLike = None) -> Cache:
        """Empty cache sized for a ``seq_len`` context: k and v (L_att, B,
        C, KV, hd) (an MLA stack's ``latent`` (L, B, C, r + d_rope)) and
        ``kv_pos`` (B, C) for the attention layers; RWKV-6's
        S (L, B, H, hd, hd) float32, x_tm and x_cm (L, B, d); the RG-LRU's
        h (L_rec, B, d_rnn) float32 and conv (L_rec, B, w−1, d_rnn); and
        ``length``.  A recurrent state's size does not depend on
        ``seq_len``."""
        cfg = self.cfg
        dev = resolve_device(device)
        cache: Cache = {}
        n_kv = sum(k in ATTENTION for k in self.kinds)
        n_rwkv, n_rec = self.kinds.count("rwkv6"), self.kinds.count("recurrent")
        if n_rwkv:
            cache.update(rwkv.init_rwkv_state((n_rwkv, batch), cfg,
                                              self.dtype, dev))
        if n_rec:
            cache.update(griffin.init_recurrent_state((n_rec, batch), cfg,
                                                      self.dtype, dev))
        if n_kv:
            C = self.cache_capacity(seq_len)
            if cfg.mla.enabled:
                cache["latent"] = torch.zeros(
                    (n_kv, batch, C, mla.latent_width(cfg)), dtype=self.dtype,
                    device=dev)
            else:
                shape = (n_kv, batch, C, cfg.n_kv_heads,
                         cfg.resolved_head_dim)
                cache.update(
                    k=torch.zeros(shape, dtype=self.dtype, device=dev),
                    v=torch.zeros(shape, dtype=self.dtype, device=dev))
            cache["kv_pos"] = torch.full((batch, C), -1, dtype=torch.int32,
                                         device=dev)
        cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
        return cache

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor, *,
                max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        """Process a prompt (B, S); return (the last position's logits (B, V)
        in float32, the filled cache).

        Logits are computed for the last position only, as the reference's.
        ``max_len`` sizes the cache for the decode steps to come (default
        the prompt; prompt + new tokens decodes without overwriting the
        earliest positions).  Each layer's entry lands in the cache as the
        layers run: a recurrent layer's final state; an attention layer's
        k and v of the prompt's last min(C, S) positions in slots 0, 1,
        ..., zeros past the prompt; a window keeps its last C positions,
        and the ring's slot of position p is p % C, so that crop needs
        S % C == 0.  An RWKV-6 stack runs the prompt PREFILL_CHUNK tokens
        at a time through :meth:`_extend`, the states carried in the
        cache."""
        B, S = tokens.shape
        cache = self.init_cache(B, max(max_len, S), device=tokens.device)
        if set(self.kinds) == {"rwkv6"}:
            for chunk in tokens.split(PREFILL_CHUNK, 1):
                h = self._extend(params, cache, chunk)
            cache["length"].fill_(S)
            return self._logits(params, h[:, -1:])[:, -1], cache
        n = S
        if "kv_pos" in cache:
            C = cache["kv_pos"].shape[1]
            if C < S and S % C:
                raise ValueError(
                    f"windowed prefill->decode needs prompt length ({S}) to "
                    f"be a multiple of the window ({C})")
            n = min(C, S)   # the prompt's last n positions fill slots 0..n-1

        def store(i, entry):
            j = self._slot[i]
            if "latent" in cache:
                cache["latent"][j, :, :n].copy_(entry[:, S - n:])
                return
            if self.kinds[i] in ATTENTION:
                k, v = entry
                cache["k"][j, :, :n].copy_(k[:, S - n:])
                cache["v"][j, :, :n].copy_(v[:, S - n:])
                return
            for name, t in entry.items():
                cache[name][j].copy_(t)

        h, _ = self._backbone(params, tokens, stacked=False, remat=False,
                              store=store)
        logits = self._logits(params, h[:, -1:])
        if "kv_pos" in cache:
            cache["kv_pos"][:, :n] = torch.arange(
                S - n, S, dtype=torch.int32, device=tokens.device)
        cache["length"].fill_(S)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1): one decode step against the cache.  Returns (the
        logits (B, 1, V) in float32, the cache after the step).  The
        cache's k and v and its recurrent states are written in place, and
        the returned cache shares them: the one passed in is spent."""
        B = tokens.shape[0]
        length = cache["length"]
        positions = length.expand(B, 1)
        new = dict(cache, length=length + 1)
        slot = None
        if "kv_pos" in cache:
            slot = torch.remainder(length, cache["kv_pos"].shape[1]
                                   ).long().reshape(1)
            new["kv_pos"] = cache["kv_pos"].index_copy(1, slot, positions)
        x = self._extend(params, cache, tokens, positions, slot)
        return self._logits(params, x), new

    def _extend(self, params: Params, cache: Cache, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                slot: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run tokens (B, T) through the layers from the cache's states,
        each layer's new state written into the cache in place (an
        attention layer's k and v at ``slot``, which takes T = 1 and
        ``positions`` (B, 1)).  Returns the final normed hidden states
        (B, T, d)."""
        cfg = self.cfg
        x = self._embed(params, tokens, False)
        for i, (kind, layer) in enumerate(zip(self.kinds,
                                              self._layers(params, False))):
            j = self._slot[i]
            if kind == "rwkv6":
                state = {n: cache[n][j] for n in ("S", "x_tm", "x_cm")}
                x, entry = rwkv.rwkv_block(
                    _sub(layer, "rwkv"), x, _sub(layer, "norm1"),
                    _sub(layer, "norm2"), state, cfg)
                for n, t in entry.items():
                    state[n].copy_(t)
                continue
            h = common.apply_norm(x, _sub(layer, "norm1"), cfg)
            if kind == "recurrent":
                state = {n: cache[n][j] for n in ("h", "conv")}
                mix, entry = griffin.recurrent_block(_sub(layer, "rec"), h,
                                                     state, cfg)
                for n, t in entry.items():
                    state[n].copy_(t)
            elif cfg.mla.enabled:
                mix = mla.mla_decode(
                    _sub(layer, "mla"), h, positions, cfg,
                    cache=cache["latent"][j], kv_pos=cache["kv_pos"],
                    write_slot=slot, window=block_window(cfg, kind))
            else:
                mix = attn.decode_self_attention(
                    _sub(layer, "attn"), h, positions, cfg,
                    cache_k=cache["k"][j], cache_v=cache["v"][j],
                    kv_pos=cache["kv_pos"], write_slot=slot,
                    window=block_window(cfg, kind))
            x, _ = self._ff_residual(layer, x + mix.to(x.dtype))
        return common.apply_norm(x, _sub(params, "final_norm"), cfg)


def _sub(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix/``, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}
