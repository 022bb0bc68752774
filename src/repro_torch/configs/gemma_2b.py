"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.

GeGLU, head_dim=256 (wider than d_model/heads), MQA [arXiv:2403.08295]."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="gemma-2b",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="geglu",
    tie_embeddings=True,
)

_REDUCED = ModelConfig(
    name="gemma-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab=256,
    head_dim=32,
    act="geglu",
    tie_embeddings=True,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED,
                    notes="full attention: long_500k N/A")
