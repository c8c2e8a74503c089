"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.

[arXiv:2402.00838] OLMo: Accelerating the Science of Language Models.
"""
from repro_torch.config import Config, ModelConfig

CONFIG = Config(
    model=ModelConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm_type="nonparametric_ln",
        activation="silu",
        tie_embeddings=True,
        max_seq_len=524_288,
        source="arXiv:2402.00838",
    ),
)
