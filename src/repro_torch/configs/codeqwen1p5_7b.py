"""codeqwen1.5-7b [dense]: 32L d=4096 32H (kv=32) d_ff=13440 vocab=92416.

qwen1.5 arch: QKV bias, SwiGLU [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.common import ArchSpec
from repro_torch.models.transformer import ModelConfig

_FULL = ModelConfig(
    name="codeqwen1.5-7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1e6,
    act="swiglu",
    tie_embeddings=False,
)

_REDUCED = ModelConfig(
    name="codeqwen-reduced",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab=128,
    qkv_bias=True,
    act="swiglu",
    tie_embeddings=False,
    compute_dtype="float32",
)


def spec() -> ArchSpec:
    return ArchSpec(model=_FULL, reduced=_REDUCED,
                    notes="full attention: long_500k N/A")
