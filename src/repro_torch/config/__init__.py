from repro_torch.config.base import (
    POWER_POLICIES,
    SELECTION_POLICIES,
    ChannelConfig,
    Config,
    ConvergenceConfig,
    EnergyConfig,
    FleetConfig,
    FLConfig,
    ModelConfig,
    PowerConfig,
    QuantConfig,
    TrainConfig,
)

__all__ = ["POWER_POLICIES", "SELECTION_POLICIES", "ChannelConfig", "Config",
           "ConvergenceConfig", "EnergyConfig", "FleetConfig", "FLConfig",
           "ModelConfig", "PowerConfig", "QuantConfig", "TrainConfig"]
