"""Arch spec plumbing shared by all 10 assigned architecture configs.

Each config module exposes `spec() -> ArchSpec`. The full ModelConfig is
the published width; tests instantiate `reduced`, and chip_smoke.py runs
qwen2-1.5b and rwkv6-1.6b whole and mixtral-8x22b at full width on one card.

Shapes (assigned, LM family — seq_len x global_batch):
  train_4k     4,096 x 256   train_step
  prefill_32k  32,768 x 32   serve prefill (full-sequence forward)
  decode_32k   32,768 x 128  serve decode (1 new token, KV cache = seq_len)
  long_500k    524,288 x 1   long-context decode; sub-quadratic archs only
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import ModelConfig

SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def _spec(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    reduced: ModelConfig
    opt_dtype: str = "float32"  # Adam moment dtype (bf16 for the >=398B archs)
    modality: str = "text"  # text | vlm | audio (stub frontends)
    long_context_ok: bool = False  # sub-quadratic => long_500k eligible
    notes: str = ""

    def shape_supported(self, shape: str) -> bool:
        if shape == "long_500k":
            return self.long_context_ok
        return shape in SHAPES

    def _input_struct(self, batch: int, seq: int) -> torch.Tensor:
        if self.modality == "text":
            return _spec((batch, seq), torch.int32)
        # stub (non-text) frontend: precomputed patch/frame embeddings
        return _spec((batch, seq, self.model.d_model), torch.bfloat16)

    def input_specs(self, shape: str) -> dict[str, torch.Tensor]:
        """Meta-device stand-ins (shape and dtype, no storage) for every
        model input of `shape`."""
        seq, batch, kind = SHAPES[shape]
        if kind == "train":
            return {
                "inputs": self._input_struct(batch, seq),
                "labels": _spec((batch, seq), torch.int32),
            }
        if kind == "prefill":
            return {"inputs": self._input_struct(batch, seq)}
        # decode: one new token against a KV cache of length seq; the cache's
        # shapes are init_cache(cfg, batch, seq)'s
        return {"inputs": self._input_struct(batch, 1), "cur_len": _spec((), torch.int32)}
