"""chameleon-34b [vlm] — early-fusion multimodal LM with VQ image tokens.

[arXiv:2405.09818] Chameleon: Mixed-Modal Early-Fusion Foundation Models.
The vision side is a VQ-VAE tokenizer whose codes share the text vocabulary —
the backbone is a dense decoder-only transformer; the tokenizer frontend is a
STUB per the assignment (``input_specs`` provides token ids directly).
"""
from repro_torch.config import Config, FLConfig, ModelConfig, TrainConfig

CONFIG = Config(
    model=ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        norm_type="rmsnorm",
        activation="silu",
        rope_theta=10000.0,
        frontend="vq_tokens",
        max_seq_len=524_288,
        source="arXiv:2405.09818",
    ),
    train=TrainConfig(fsdp=True),
    # FSDP over `data` => client cohorts live on the `pod` axis (DESIGN.md §6)
    fl=FLConfig(cohort_axes=("pod",)),
)
