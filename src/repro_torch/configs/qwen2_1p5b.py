"""qwen2-1.5b [dense]: 28L d=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

GQA + QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="qwen2-1.5b",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    act="swiglu",
    tie_embeddings=True,
)

_REDUCED = ModelConfig(
    name="qwen2-reduced",
    num_layers=2,
    d_model=48,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab=128,
    head_dim=16,
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=True,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED,
                    notes="full attention: long_500k N/A")
