"""mnist_cnn [cnn] — the paper's own QNN (§IV).

Two quantized conv layers (32, 64 kernels @3x3, pad 1, stride 1, each followed
by ReLU + 2x2 maxpool) and two quantized FC layers (128 units, then 10).
421,642 weights and 4,241,152 MACs/sample — asserted exactly in tests.
"""
from repro_torch.config import Config, ModelConfig, TrainConfig

CONFIG = Config(
    model=ModelConfig(
        name="mnist_cnn",
        family="cnn",
        n_layers=4,            # conv1, conv2, fc1, fc2
        d_model=128,           # fc hidden
        n_heads=1,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=10,         # classes
        norm_type="layernorm",
        activation="relu",
        max_seq_len=784,
        source="paper §IV (Compaoré et al. 2025)",
    ),
    train=TrainConfig(global_batch=32, seq_len=784, optimizer="sgd",
                      learning_rate=0.001),
)

# Paper-stated ground truth, used by tests and the energy model.
PAPER_WEIGHTS = 421_642
PAPER_MACS = 4_241_152
