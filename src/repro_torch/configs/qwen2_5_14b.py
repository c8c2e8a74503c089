"""qwen2.5-14b [dense] — GQA with QKV bias.

[hf:Qwen/Qwen2.5-0.5B model card, scaled to the assigned 14B dims]
"""
from repro_torch.config import Config, ModelConfig

CONFIG = Config(
    model=ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        norm_type="rmsnorm",
        activation="silu",
        rope_theta=1_000_000.0,
        max_seq_len=524_288,
        source="hf:Qwen/Qwen2.5-0.5B",
    ),
)
