"""The LM stack on PyTorch: layers, attention, MoE, SSM blocks and the
decoder-only transformer over them (see transformer.py)."""
from repro_torch.models.transformer import ModelConfig, MoEConfig, init_params, apply_model
from repro_torch.models import layers, attention, moe, ssm

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "init_params",
    "apply_model",
    "layers",
    "attention",
    "moe",
    "ssm",
]
