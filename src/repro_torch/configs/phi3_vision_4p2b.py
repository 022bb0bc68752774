"""phi-3-vision-4.2b [vlm]: 32L d=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

phi3-mini backbone + CLIP frontend [hf:microsoft/Phi-3-vision-128k-instruct].
The CLIP image frontend is a STUB per assignment: input_specs() hands the
backbone precomputed patch embeddings. RoPE theta 10k (the 128k-context
LongRoPE scaling is out of scope; noted in DESIGN.md).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="phi-3-vision-4.2b",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
)

_REDUCED = ModelConfig(
    name="phi-3-vision-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=128,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, modality="vlm",
                    notes="full attention: long_500k N/A")
