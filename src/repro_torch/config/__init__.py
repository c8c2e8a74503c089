from repro_torch.config.base import (
    ChannelConfig,
    Config,
    EnergyConfig,
    FLConfig,
    ModelConfig,
    QuantConfig,
    TrainConfig,
)

__all__ = ["ChannelConfig", "Config", "EnergyConfig", "FLConfig",
           "ModelConfig", "QuantConfig", "TrainConfig"]
