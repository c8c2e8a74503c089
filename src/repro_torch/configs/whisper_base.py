"""whisper-base [audio] — encoder-decoder with conv/mel frontend (STUB).

[arXiv:2212.04356] Robust Speech Recognition via Large-Scale Weak Supervision.
The mel-spectrogram + conv feature extractor is stubbed per the assignment:
``input_specs`` provides precomputed frame embeddings (batch, 1500, 512).
``long_500k`` is SKIPPED for this arch (448-position decoder; see DESIGN.md).
"""
from repro_torch.config import Config, ModelConfig

CONFIG = Config(
    model=ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,            # decoder layers
        n_encoder_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        norm_type="layernorm",
        activation="gelu",
        gated_mlp=False,
        is_encoder_decoder=True,
        encoder_seq_len=1500,
        frontend="audio_frames",
        max_seq_len=32_768,
        source="arXiv:2212.04356",
    ),
)
