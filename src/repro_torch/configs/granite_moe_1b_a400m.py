"""granite-moe-1b-a400m [moe] — 32 experts, top-8 routing.

[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.config import Config, ModelConfig, MoEConfig

CONFIG = Config(
    model=ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        norm_type="rmsnorm",
        activation="silu",
        moe=MoEConfig(
            num_experts=32,
            experts_per_token=8,
            expert_d_ff=512,
        ),
        max_seq_len=524_288,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    ),
)
