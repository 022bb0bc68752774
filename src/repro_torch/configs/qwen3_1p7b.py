"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.

qk_norm on per-head q/k, head_dim=128, GQA [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="qwen3-1.7b",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    act="swiglu",
    tie_embeddings=True,
)

_REDUCED = ModelConfig(
    name="qwen3-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab=128,
    head_dim=32,
    qk_norm=True,
    act="swiglu",
    tie_embeddings=True,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED,
                    notes="full attention: long_500k N/A")
