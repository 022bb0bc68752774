"""Parameters and caches carried into the port from plain numpy arrays.

`params_from_numpy` takes a parameter tree in the reference's layout (nested
dicts of arrays; `blocks` a tuple over pattern positions whose leaves are
stacked (R, ...)) and returns the port's model, with block leaf [r] of
pattern position pos in layer r * len(block_pattern) + pos.
`cache_from_numpy` keeps the cache layout as it is (a tuple over pattern
positions of tuples of stacked leaves), so caches compare leaf for leaf.
`params_to_numpy` is the inverse of `params_from_numpy`: layer
r * len(block_pattern) + pos goes back to row r of block pos.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


def reference_tree(lm: nn.Module, cfg: ModelConfig) -> dict:
    """The reference's layout of a model's tensors (or of any tree of its
    structure, such as AdamW's moments): nested dicts, `blocks` a tuple
    over pattern positions, and each block leaf a list of its R layers'
    tensors, row r from layer r * len(block_pattern) + pos."""
    unit = len(cfg.block_pattern)

    def tree(node):
        return {k: tree(node[k]) if isinstance(node[k], nn.Module) else node[k]
                for k in node.keys()}

    def rows(trees):
        first = trees[0]
        return {k: rows([t[k] for t in trees]) if isinstance(first[k], dict) else
                [t[k] for t in trees] for k in first}

    layers = [tree(b) for b in lm["blocks"]]
    return {"embed": tree(lm["embed"]), "final_norm": tree(lm["final_norm"]),
            "blocks": tuple(rows(layers[pos::unit]) for pos in range(unit))}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16 of its own: its values, exactly, in fp32
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(lm: nn.Module, cfg: ModelConfig) -> dict:
    """The reference's parameter tree as numpy arrays, block leaves stacked
    (R, ...); a bfloat16 leaf comes back as the same values in fp32."""
    def leaf(node):
        if isinstance(node, dict):
            return {k: leaf(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(leaf(v) for v in node)
        if isinstance(node, list):
            return np.stack([_numpy(t) for t in node])
        return _numpy(node)

    return leaf(reference_tree(lm, cfg))
