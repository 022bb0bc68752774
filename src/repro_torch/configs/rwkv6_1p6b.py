"""rwkv6-1.6b [ssm]: 24L d=2048 (attention-free) d_ff=7168 vocab=65536.

Finch: data-dependent decay linear attention [arXiv:2404.05892; unverified].
Attention-free => O(1) decode state; long_500k is the showcase shape.
head_dim 64 => 32 wkv heads.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="rwkv6-1.6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # wkv heads, head_dim 64
    num_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    norm="layernorm",
    tie_embeddings=False,
    block_pattern=("rwkv",),
)

_REDUCED = ModelConfig(
    name="rwkv6-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=128,
    norm="layernorm",
    tie_embeddings=False,
    compute_dtype="float32",
    block_pattern=("rwkv",),
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, long_context_ok=True,
                    notes="attention-free; decode state O(1) in context")
