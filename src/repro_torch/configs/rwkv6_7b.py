"""rwkv6-7b [ssm] — RWKV-6 "Finch": attention-free, data-dependent decay.

[arXiv:2404.05892] Eagle and Finch: RWKV with Matrix-Valued States and
Dynamic Recurrence. Decode state is O(1) in sequence length, so ``long_500k``
runs natively (no attention cache at all).
"""
from repro_torch.config import Config, ModelConfig, RecurrentConfig

CONFIG = Config(
    model=ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,           # rwkv6 head_size 64 -> 64 heads at d=4096
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        norm_type="layernorm",
        activation="relu",    # channel-mix uses squared relu internally
        recurrent=RecurrentConfig(kind="rwkv6"),
        max_seq_len=1_048_576,
        source="arXiv:2404.05892",
    ),
)
