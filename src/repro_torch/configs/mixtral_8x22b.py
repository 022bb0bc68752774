"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088].

SWA window 4096 => the decode KV cache is a rotating 4k buffer, making
long_500k eligible (sub-quadratic in context length).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="mixtral-8x22b",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    head_dim=128,
    act="swiglu",
    sliding_window=4096,
    tie_embeddings=False,
    param_dtype="bfloat16",
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=16384, every_n=1),
)

_REDUCED = ModelConfig(
    name="mixtral-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab=128,
    sliding_window=8,
    act="swiglu",
    tie_embeddings=False,
    compute_dtype="float32",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=128, every_n=1),
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, long_context_ok=True,
                    notes="SWA => long_500k runs with a 4k rotating KV buffer")
