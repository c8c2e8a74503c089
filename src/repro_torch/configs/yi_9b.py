"""yi-9b [dense] — llama-architecture GQA.

[arXiv:2403.04652] Yi: Open Foundation Models by 01.AI.
"""
from repro_torch.config import Config, ModelConfig

CONFIG = Config(
    model=ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        norm_type="rmsnorm",
        activation="silu",
        rope_theta=10000.0,
        max_seq_len=524_288,
        source="arXiv:2403.04652",
    ),
)
