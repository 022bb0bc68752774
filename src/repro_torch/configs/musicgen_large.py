"""musicgen-large [audio]: 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens [arXiv:2306.05284]. The EnCodec frontend is
a STUB: input_specs() provides frame embeddings. MusicGen uses pre-LN
LayerNorm + GELU; we keep those and use RoPE in place of its learned
positional embeddings (adaptation noted in DESIGN.md).
"""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="musicgen-large",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    norm="layernorm",
    tie_embeddings=False,
)

_REDUCED = ModelConfig(
    name="musicgen-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab=64,
    act="gelu",
    norm="layernorm",
    tie_embeddings=False,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED, modality="audio",
                    notes="full attention: long_500k N/A")
