"""Model zoo on torch tensors; the dense decoder path is ported so far."""

from repro_torch.models.common import MLAConfig, MoEConfig, ModelConfig, SSMConfig

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "MLAConfig"]
