"""Whisper-style encoder-decoder (arXiv:2212.04356): the reference's
``repro.models.whisper`` in PyTorch, its audio frontend a stub as there.

The inputs are precomputed frame embeddings ``frames`` (B, Se, d) and
decoder tokens (B, S).  Positions are rope in the encoder and the decoder,
not Whisper's learned embeddings, as the reference has them.  The encoder
is non-causal self-attention and an MLP a layer; each decoder layer runs
causal self-attention, cross-attention to the encoder's output and an MLP.

Parameters are a dict keyed by the reference's leaf paths: the encoder's
layers stacked (L_enc, ...) under "enc/", the decoder's (L, ...) under
"dec/", and "embed", "enc_norm", "final_norm" and "head"; the norms'
scales and biases float32 and the rest the model's dtype
(``param_shapes``, a :class:`convert.Layout`).  ``loss`` runs one model;
``loss_stacked`` runs C cohorts at once, a leading C on every leaf and on
the tokens, labels and frames (``core.fl.local_sgd``).

Placed on a rank of the distributed round (``sharding.placement``), the
model holds its blocks and runs tensor-parallel over ``tp``'s model
group as the LM does: both stacks' self-attention and MLP on the rank's
heads and ff columns, the cross-attention on its heads, the encoder's
states through f once ahead of every decoder layer's cross k and v
(``attention.project_cross_kv``), and the vocabulary's blocks where the
table and head shard (:class:`transformer.VocabParallel`).

The decode cache holds the decoder's self-attention ``k`` and ``v`` (L, B,
C, KV, hd), the cross-attention's ``cross_k`` and ``cross_v`` (L, B, Se,
KV, hd), projected once in ``prefill``, ``kv_pos`` (B, C) and ``length``;
``decode_step`` writes k and v in place at ``length % C``, derived on the
device, with no synchronizing call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import convert
from repro_torch.config.base import Config, ModelConfig
from repro_torch.device import DeviceLike, make_generator, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp
from repro_torch.models.transformer import VocabParallel, _sub, torch_dtype

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def _layer_leaves(cfg: ModelConfig, mixers: Tuple[Tuple[str, str], ...]
                  ) -> Dict[str, Tuple[Tuple[int, ...], bool]]:
    """One layer's leaves by path -> (shape, float32): each (norm, mixer)
    pair's norm and attention leaves, then "norm2" and "mlp"."""
    out = {}
    norms = common.norm_param_shapes(cfg, cfg.d_model)
    for norm, mixer in mixers + (("norm2", None),):
        for k, s in norms.items():
            out[f"{norm}/{k}"] = (s, True)
        if mixer is not None:
            for k, s in attn.attention_param_shapes(cfg).items():
                out[f"{mixer}/{k}"] = (s, False)
    for k, s in mlp.mlp_param_shapes(cfg).items():
        out[f"mlp/{k}"] = (s, False)
    return out


ENC_MIXERS = (("norm1", "attn"),)
DEC_MIXERS = (("norm1", "self_attn"), ("norm_x", "cross_attn"))


def whisper_param_shapes(cfg: ModelConfig) -> convert.Layout:
    leaves = {"embed": ((cfg.vocab_size, cfg.d_model), False),
              "head": ((cfg.d_model, cfg.vocab_size), False)}
    for norm in ("enc_norm", "final_norm"):
        for k, s in common.norm_param_shapes(cfg, cfg.d_model).items():
            leaves[f"{norm}/{k}"] = (s, True)
    for pre, L, mixers in (("enc", cfg.n_encoder_layers, ENC_MIXERS),
                           ("dec", cfg.n_layers, DEC_MIXERS)):
        for k, (s, f32) in _layer_leaves(cfg, mixers).items():
            leaves[f"{pre}/{k}"] = ((L,) + s, f32)
    dt = torch_dtype(cfg)
    return convert.Layout({k: s for k, (s, _) in leaves.items()},
                          {k: torch.float32 if f32 else dt
                           for k, (_, f32) in leaves.items()})


@dataclass
class WhisperModel(VocabParallel):
    """The encoder-decoder (family ``audio``, ``is_encoder_decoder``)."""
    config: Config

    def __post_init__(self):
        self.param_shapes = whisper_param_shapes(self.cfg)
        self.num_params = self.param_shapes.numel

    @property
    def cfg(self) -> ModelConfig:
        return self.config.model

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg)

    #: the reference's loss ignores its rng: no fake-quant in local steps
    quantizes_training = False

    # -- init ------------------------------------------------------------------

    def init_flat(self, seed: Union[int, torch.Generator] = 0, *,
                  device: DeviceLike = None) -> convert.Flat:
        """The flat parameters from one generator: the embedding N(0,
        0.02²); the encoder's layers, then the decoder's, each attention
        and MLP matrix N(0, 1/fan_in), the norms ``make_norm_params``
        (float32); the two final norms; the head N(0, 1/d).  The draws
        are the port's own (a parity test converts the reference's
        parameters, ``convert.flat_from_tree``)."""
        cfg, dt = self.cfg, self.dtype
        dev = resolve_device(device)
        gen = make_generator(seed, dev)
        flat = self.param_shapes.empty(device=dev)
        views = convert.unflatten_params(flat, self.param_shapes)
        norm = common.make_norm_params(cfg, cfg.d_model, device=dev)

        def put(path, v, layer=None):
            # a placed model keeps its block of each leaf drawn whole
            if self.placement is not None:
                v = self.placement.block(path, v, layer=layer is not None)
            (views[path] if layer is None else views[path][layer]).copy_(v)

        def fill(prefix, leaves, layer=None):
            for k, v in leaves.items():
                put(f"{prefix}/{k}", v, layer)

        put("embed", common.embed_init(gen, (cfg.vocab_size, cfg.d_model)))
        for pre, L, mixers in (("enc", cfg.n_encoder_layers, ENC_MIXERS),
                               ("dec", cfg.n_layers, DEC_MIXERS)):
            for i in range(L):
                for norm_name, mixer in mixers:
                    fill(f"{pre}/{norm_name}", norm, i)
                    fill(f"{pre}/{mixer}", attn.init_attention_params(
                        gen, cfg, dtype=dt), i)
                fill(f"{pre}/norm2", norm, i)
                fill(f"{pre}/mlp", mlp.init_mlp_params(gen, cfg, dtype=dt), i)
        fill("enc_norm", norm)
        fill("final_norm", norm)
        put("head", common.dense_init(gen, (cfg.d_model, cfg.vocab_size)))
        return flat

    def init(self, seed: Union[int, torch.Generator] = 0, *,
             device: DeviceLike = None) -> Params:
        """:meth:`init_flat`'s leaves by path (views of its buffers)."""
        return convert.unflatten_params(self.init_flat(seed, device=device),
                                        self.param_shapes)

    def _layers(self, params: Params, prefix: str, stacked: bool):
        """Each layer's leaves under ``prefix`` ("enc" or "dec"), keyed by
        their path below the layer; a stacked leaf unbound once."""
        n = len(prefix) + 1
        blocks = {k[n:]: v.unbind(1 if stacked else 0)
                  for k, v in params.items() if k.startswith(prefix + "/")}
        L = len(next(iter(blocks.values())))
        return [{k: v[i] for k, v in blocks.items()} for i in range(L)]

    # -- encoder ---------------------------------------------------------------

    def encode(self, params: Params, frames: torch.Tensor, *,
               stacked: bool = False) -> torch.Tensor:
        """frames (B, Se, d), or (C, B, Se, d) stacked -> the encoder's
        normed states in the model's dtype: non-causal self-attention
        with rope on q and k, and an MLP, a layer."""
        cfg = self.cfg
        B, Se = frames.shape[-3:-1]
        positions = torch.arange(Se, dtype=torch.int32,
                                 device=frames.device).expand(B, Se)
        h = frames.to(self.dtype)
        for lp in self._layers(params, "enc", stacked):
            a = common.apply_norm(h, _sub(lp, "norm1"), cfg)
            sa = _sub(lp, "attn")
            q, k, v = attn._project_qkv(sa, a, cfg, self.tp)
            q = common.apply_rope(q, positions, cfg.rope_theta)
            k = common.apply_rope(k, positions, cfg.rope_theta)
            o = attn.attend(q, k, v, positions, positions, causal=False)
            o = o.reshape(*h.shape[:-1], -1)
            h = h + (common.row_linear(o, sa["wo"], self.tp)
                     if attn._tp_heads(sa, cfg, self.tp)
                     else common.linear(o, sa["wo"]))
            m = common.apply_norm(h, _sub(lp, "norm2"), cfg)
            h = h + mlp.mlp(_sub(lp, "mlp"), m, cfg, self.tp)
        return common.apply_norm(h, _sub(params, "enc_norm"), cfg)

    # -- decoder ---------------------------------------------------------------

    def _decoder_full(self, params: Params, tokens: torch.Tensor,
                      enc_out: torch.Tensor, *, stacked: bool = False,
                      last_only: bool = False,
                      store: Optional[Callable[[int, Tuple], None]] = None
                      ) -> torch.Tensor:
        """The teacher-forced decoder over tokens (B, S), or (C, B, S)
        stacked, against the encoder's states: the logits (..., S, V), or
        the last position's (..., 1, V) with ``last_only``, in float32.
        ``store(i, (k, v, cross_k, cross_v))``, where given, takes layer
        i's rope'd self-attention k and v and its cross k and v."""
        cfg = self.cfg
        B, S = tokens.shape[-2:]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        h = self._embed(params, tokens, stacked)
        if attn._tp_heads(_sub(params, "dec/cross_attn"), cfg, self.tp):
            # every layer's cross k and v read the rank's heads: f once
            enc_out = common.column_input(enc_out, self.tp)
        for i, lp in enumerate(self._layers(params, "dec", stacked)):
            a = common.apply_norm(h, _sub(lp, "norm1"), cfg)
            sa, (k, v) = attn.self_attention(_sub(lp, "self_attn"), a,
                                             positions, cfg, tp=self.tp)
            h = h + sa
            c = common.apply_norm(h, _sub(lp, "norm_x"), cfg)
            cross = _sub(lp, "cross_attn")
            ek, ev = attn.project_cross_kv(cross, enc_out, cfg, self.tp)
            h = h + attn.cross_attention(cross, c, ek, ev, cfg, self.tp)
            if store is not None:
                store(i, (k, v, ek, ev))
            del k, v, ek, ev
            m = common.apply_norm(h, _sub(lp, "norm2"), cfg)
            h = h + mlp.mlp(_sub(lp, "mlp"), m, cfg, self.tp)
        h = common.apply_norm(h, _sub(params, "final_norm"), cfg)
        if last_only:
            h = h[..., -1:, :]
        return self._logits(params, h)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], rng=None,
             *, remat: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The mean cross-entropy of the decoder over the batch's tokens and
        labels (B, S) given its frames (B, Se, d); ``rng`` and ``remat``
        are ignored, as the reference's."""
        enc_out = self.encode(params, batch["frames"])
        logits = self._decoder_full(params, batch["tokens"], enc_out)
        ce = self._ce(logits, batch["labels"])
        return ce, {"ce": ce}

    def loss_stacked(self, params: Params, batch: Dict[str, torch.Tensor], *,
                     remat: Optional[bool] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """C cohorts at once: leaves (C, ...), tokens and labels (C, B, S),
        frames (C, B, Se, d).  Returns each cohort's loss and token
        accuracy, (C,) each (the accuracy without gradient)."""
        enc_out = self.encode(params, batch["frames"], stacked=True)
        logits = self._decoder_full(params, batch["tokens"], enc_out,
                                    stacked=True)
        ce = self._ce(logits, batch["labels"])
        with torch.no_grad():
            hit = self._argmax(logits) == batch["labels"].long()
            acc = hit.float().mean(dim=(-2, -1))
        return ce, acc

    # -- serving ---------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int, *,
                   device: DeviceLike = None) -> Cache:
        """Empty cache for a ``seq_len`` decoder context: k and v (L, B,
        seq_len, KV, hd), cross_k and cross_v (L, B, Se, KV, hd) at the
        config's ``encoder_seq_len``, kv_pos (B, seq_len) and
        ``length``."""
        cfg = self.cfg
        dev = resolve_device(device)
        L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim

        def zeros(n):
            return torch.zeros((L, batch, n, KV, hd), dtype=self.dtype,
                               device=dev)

        return {"k": zeros(seq_len), "v": zeros(seq_len),
                "cross_k": zeros(cfg.encoder_seq_len),
                "cross_v": zeros(cfg.encoder_seq_len),
                "kv_pos": torch.full((batch, seq_len), -1, dtype=torch.int32,
                                     device=dev),
                "length": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def prefill(self, params: Params, tokens: torch.Tensor,
                frames: torch.Tensor, *, max_len: int = 0
                ) -> Tuple[torch.Tensor, Cache]:
        """Encode the frames (B, Se, d) and run the prompt (B, S) through
        the decoder: (the last position's logits (B, V) in float32, the
        cache).  ``max_len`` sizes the self-attention cache (default the
        prompt); the cross k and v are projected here once."""
        B, S = tokens.shape
        cache = self.init_cache(B, max(max_len, S), device=tokens.device)
        enc_out = self.encode(params, frames)
        cross = ([], [])

        def store(i, entry):
            k, v, ek, ev = entry
            cache["k"][i, :, :S].copy_(k)
            cache["v"][i, :, :S].copy_(v)
            cross[0].append(ek)
            cross[1].append(ev)

        logits = self._decoder_full(params, tokens, enc_out, last_only=True,
                                    store=store)
        cache["cross_k"], cache["cross_v"] = map(torch.stack, cross)
        cache["kv_pos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                              device=tokens.device)
        cache["length"].fill_(S)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode_step(self, params: Params, cache: Cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1): one decoder step against the cache.  Returns (the
        logits (B, 1, V) in float32, the cache after the step); k and v
        are written in place, so the cache passed in is spent."""
        cfg = self.cfg
        B = tokens.shape[0]
        length = cache["length"]
        positions = length.expand(B, 1)
        slot = torch.remainder(length, cache["k"].shape[2]).long().reshape(1)
        h = self._embed(params, tokens, False)
        for i, lp in enumerate(self._layers(params, "dec", False)):
            a = common.apply_norm(h, _sub(lp, "norm1"), cfg)
            h = h + attn.decode_self_attention(
                _sub(lp, "self_attn"), a, positions, cfg,
                cache_k=cache["k"][i], cache_v=cache["v"][i],
                kv_pos=cache["kv_pos"], write_slot=slot)
            c = common.apply_norm(h, _sub(lp, "norm_x"), cfg)
            h = h + attn.cross_attention(_sub(lp, "cross_attn"), c,
                                         cache["cross_k"][i],
                                         cache["cross_v"][i], cfg)
            m = common.apply_norm(h, _sub(lp, "norm2"), cfg)
            h = h + mlp.mlp(_sub(lp, "mlp"), m, cfg)
        h = common.apply_norm(h, _sub(params, "final_norm"), cfg)
        new = dict(cache, length=length + 1,
                   kv_pos=cache["kv_pos"].index_copy(1, slot, positions))
        return self._logits(params, h), new
