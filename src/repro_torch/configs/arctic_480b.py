"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

Arctic's signature dense-MoE hybrid: every layer has a (small) dense FFN
residual branch in parallel with the 128-expert MoE. Expert d_ff = 4864 as
assigned; the dense branch uses 2*d_model (approximation, noted).
At 480B params the dry-run dtype policy is bf16 params + bf16 Adam moments
(fits 256 x 16 GB; see DESIGN.md Sec 6).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="arctic-480b",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=14336,  # dense path (unused: every layer is MoE)
    vocab=32000,
    head_dim=128,
    act="swiglu",
    tie_embeddings=False,
    param_dtype="bfloat16",
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, dense_residual=True,
                  d_ff_dense=14336, every_n=1),
)

_REDUCED = ModelConfig(
    name="arctic-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab=128,
    act="swiglu",
    tie_embeddings=False,
    compute_dtype="float32",
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=64, dense_residual=True,
                  d_ff_dense=128, every_n=1),
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, opt_dtype="bfloat16",
                    notes="full attention: long_500k N/A")
