"""nemotron-4-340b [dense] — GQA with squared-ReLU MLP (no gate).

[arXiv:2402.16819] Nemotron-4 340B Technical Report.
Needs TP + FSDP to fit: 340B bf16 params = 680 GB -> 2.7 GB/chip on 256 chips.
"""
from repro_torch.config import Config, FLConfig, ModelConfig, TrainConfig

CONFIG = Config(
    model=ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18432,
        n_heads=96,
        n_kv_heads=8,
        d_ff=73728,
        vocab_size=256000,
        norm_type="layernorm",
        activation="relu2",     # squared ReLU, 2-matrix MLP
        gated_mlp=False,
        rope_theta=10000.0,
        max_seq_len=524_288,
        source="arXiv:2402.16819",
    ),
    train=TrainConfig(fsdp=True),
    # FSDP over `data` => client cohorts live on the `pod` axis (DESIGN.md §6)
    fl=FLConfig(cohort_axes=("pod",)),
)
