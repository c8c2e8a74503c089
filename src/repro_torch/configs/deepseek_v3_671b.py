"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8, MTP.

[arXiv:2412.19437] DeepSeek-V3 Technical Report.
d_ff=2048 is the per-expert (routed) intermediate size per the assignment.
"""
from repro_torch.config import Config, FLConfig, MLAConfig, ModelConfig, MoEConfig, TrainConfig

CONFIG = Config(
    model=ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,        # MLA: all heads read the shared latent KV
        d_ff=2048,
        vocab_size=129280,
        norm_type="rmsnorm",
        activation="silu",
        moe=MoEConfig(
            num_experts=256,
            experts_per_token=8,
            num_shared_experts=1,
            expert_d_ff=2048,
        ),
        mla=MLAConfig(
            enabled=True,
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_rope_head_dim=64,
            qk_nope_head_dim=128,
            v_head_dim=128,
        ),
        mtp_depth=1,
        max_seq_len=524_288,
        source="arXiv:2412.19437",
    ),
    train=TrainConfig(fsdp=True),
    # FSDP over `data` => client cohorts live on the `pod` axis (DESIGN.md §6)
    fl=FLConfig(cohort_axes=("pod",)),
)
