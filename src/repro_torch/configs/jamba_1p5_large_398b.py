"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887].

Pattern unit = 8 layers (1 attn + 7 mamba), scanned 9x. MoE every other
layer. Hybrid => long_500k eligible (only 9 attention layers hold KV;
mamba layers carry O(1) state). bf16 params + bf16 moments at 398B.
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    act="swiglu",
    tie_embeddings=False,
    param_dtype="bfloat16",
    block_pattern=("attn",) + ("mamba",) * 7,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, every_n=2),
)

_REDUCED = ModelConfig(
    name="jamba-reduced",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab=128,
    act="swiglu",
    tie_embeddings=False,
    compute_dtype="float32",
    block_pattern=("attn",) + ("mamba",) * 3,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=128, every_n=2),
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, opt_dtype="bfloat16",
                    long_context_ok=True,
                    notes="hybrid: 9 attn layers w/ KV, 63 mamba layers O(1) state")
