"""Parameters and caches carried into the port from plain numpy arrays.

`params_from_numpy` takes a parameter tree in the reference's layout (nested
dicts of arrays; `blocks` a tuple over pattern positions whose leaves are
stacked (R, ...)) and returns the port's model, with block leaf [r] of
pattern position pos in layer r * len(block_pattern) + pos.
`cache_from_numpy` keeps the cache layout as it is (a tuple over pattern
positions of tuples of stacked leaves), so caches compare leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import LM, ModelConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: go through fp32
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _tree(node, device, r=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, r) for k, v in node.items()}
    return _tensor(node if r is None else np.asarray(node)[r], device)


def params_from_numpy(np_params: dict, cfg: ModelConfig, device) -> LM:
    unit = len(cfg.block_pattern)
    blocks = [_tree(np_params["blocks"][i % unit], device, i // unit)
              for i in range(cfg.num_layers)]
    return LM(_tree(np_params["embed"], device), _tree(np_params["final_norm"], device), blocks)


def cache_from_numpy(np_cache, device) -> tuple:
    return tuple(tuple(_tensor(leaf, device) for leaf in pos) for pos in np_cache)
