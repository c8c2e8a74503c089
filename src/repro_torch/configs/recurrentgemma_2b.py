"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427] Griffin: Mixing Gated Linear Recurrences with Local
Attention. Block pattern: (recurrent, recurrent, attention) repeated; local
attention window 2048 makes ``long_500k`` sub-quadratic natively.
"""
from repro_torch.config import Config, ModelConfig, RecurrentConfig

CONFIG = Config(
    model=ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,          # MQA in local-attention blocks
        d_ff=7680,
        vocab_size=256000,
        norm_type="rmsnorm",
        activation="gelu",
        local_window=2048,
        recurrent=RecurrentConfig(
            kind="rglru",
            d_rnn=2560,
            conv1d_width=4,
            block_pattern=("recurrent", "recurrent", "attention"),
        ),
        max_seq_len=1_048_576,
        source="arXiv:2402.19427",
    ),
)
