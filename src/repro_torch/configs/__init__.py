"""Config registry: ``get_config("olmo-1b")`` returns the module's CONFIG;
``reduced(cfg)`` returns the CPU smoke-test variant of the same family
(at most 2 layers, d_model at most 256, at most 4 experts, the RG-LRU's
width d_model, MLA's ranks and head dims cut), as the reference's;
``for_shape(cfg, shape)`` adapts a config to one of the four input shapes
of ``configs.shapes`` (a sliding window for full-attention archs on
``long_500k``)."""
from __future__ import annotations

import importlib
from dataclasses import replace
from typing import Dict, List

from repro_torch.config import Config
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape  # noqa: F401 (re-exported)

_ARCHS: Dict[str, str] = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "mnist_cnn": "repro_torch.configs.mnist_cnn",
}

#: the families ``models.build_model`` builds: every family of the
#: reference's zoo
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "cnn")

#: the sliding window ``for_shape`` gives full-attention archs on long_500k
LONG_CONTEXT_WINDOW = 8192


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(name: str) -> Config:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; valid: {sorted(_ARCHS)}")
    return importlib.import_module(_ARCHS[name]).CONFIG


def is_subquadratic(cfg: Config) -> bool:
    """True if the arch decodes 500k tokens without a full-attention cache."""
    m = cfg.model
    return m.recurrent.kind in ("rwkv6", "rglru") or m.attention_window > 0


def supports_shape(cfg: Config, shape: InputShape) -> bool:
    m = cfg.model
    if m.family == "cnn":
        return shape.kind == "train"
    if shape.name == "long_500k":
        # an encoder-decoder's short decoder has no 524k-token decode
        return not m.is_encoder_decoder
    return True


def for_shape(cfg: Config, shape: InputShape) -> Config:
    """Adapt a config to an input shape: its batch and sequence length, and
    a sliding window of LONG_CONTEXT_WINDOW for a full-attention arch on
    long_500k."""
    if not supports_shape(cfg, shape):
        raise ValueError(f"{cfg.model.name} does not support {shape.name}")
    m = cfg.model
    if (shape.name == "long_500k" and m.recurrent.kind == "none"
            and m.attention_window == 0):
        m = replace(m, attention_window=LONG_CONTEXT_WINDOW)
    train = replace(cfg.train, global_batch=shape.global_batch,
                    seq_len=shape.seq_len)
    return replace(cfg, model=m, train=train)


def reduced(cfg: Config) -> Config:
    """Smoke-test variant: same family and block structure, tiny dims (the
    reference's ``reduced``)."""
    m = cfg.model
    d = min(m.d_model, 256)
    heads = min(m.n_heads, 4)
    kv = min(m.n_kv_heads, heads)
    moe = m.moe
    if moe.enabled:
        moe = replace(moe, num_experts=min(moe.num_experts, 4),
                      experts_per_token=min(moe.experts_per_token, 2),
                      expert_d_ff=min(moe.expert_d_ff or m.d_ff, 128))
    mla = m.mla
    if mla.enabled:
        mla = replace(mla, kv_lora_rank=32, q_lora_rank=48,
                      qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32)
    rec = m.recurrent
    if rec.d_rnn:
        rec = replace(rec, d_rnn=d)
    m = replace(
        m,
        name=m.name + "-reduced",
        n_layers=min(m.n_layers, 2),
        n_encoder_layers=min(m.n_encoder_layers, 2),
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d // heads if m.family != "cnn" else 0,
        d_ff=min(m.d_ff, 512),
        vocab_size=min(m.vocab_size, 512),
        encoder_seq_len=min(m.encoder_seq_len, 64),
        local_window=min(m.local_window, 16),
        attention_window=min(m.attention_window, 16) if m.attention_window else 0,
        max_seq_len=min(m.max_seq_len, 2048),
        moe=moe,
        mla=mla,
        recurrent=rec,
    )
    train = replace(cfg.train, global_batch=2, seq_len=32, steps=2, fsdp=False)
    return replace(cfg, model=m, train=train)
