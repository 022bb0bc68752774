"""Registry of the 10 assigned architectures (--arch <id>)."""
from repro_torch.configs.common import SHAPES, ArchSpec

ARCHS = {
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1p5_7b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1p5b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1p5_large_398b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1p6b",
}


def get_arch(name: str) -> ArchSpec:
    import importlib

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[name]).spec()


__all__ = ["ARCHS", "SHAPES", "ArchSpec", "get_arch"]
