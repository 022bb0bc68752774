"""Fault-tolerant checkpointing in the reference's on-disk format.

  * Leaves are saved as full arrays in one leaves.npz per checkpoint, keyed
    by the reference's pytree paths (jax.tree_util.keystr of its tree:
    "['params']['blocks'][0]['mixer']['wq']"), plus a JSON manifest {step,
    leaf paths, shapes, dtypes}. A model (one module per layer here) is
    saved in the reference's layout, its layers re-stacked into (R, ...)
    block leaves (`carry.reference_tree`), and so are AdamW's moments; a
    checkpoint written by either package restores in the other.
  * bfloat16 leaves are stored as raw uint16 (numpy has no bfloat16).
  * Writes are atomic (tmp dir + rename) so a failure mid-write never
    corrupts the latest checkpoint; `latest_step` scans completed
    manifests only.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
from torch import nn

from repro_torch.models.carry import reference_tree
from repro_torch.models.transformer import ModelConfig


def _flatten(tree, cfg: ModelConfig | None, path: str = "") -> dict:
    """keystr path -> a tensor, or a list of the tensors a stacked block
    leaf holds (row r first), in the reference's key order."""
    if isinstance(tree, nn.Module):
        if cfg is None:
            raise ValueError("a tree holding a model needs its ModelConfig")
        tree = reference_tree(tree, cfg)
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):  # jax flattens a dict in sorted key order
            out.update(_flatten(tree[k], cfg, f"{path}[{k!r}]"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, child in enumerate(tree):
            out.update(_flatten(child, cfg, f"{path}[{i}]"))
        return out
    return {path: tree}


def _array(leaf) -> np.ndarray:
    t = torch.stack([r.detach() for r in leaf]) if isinstance(leaf, list) else leaf.detach()
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _is_bf16(leaf) -> bool:
    return (leaf[0] if isinstance(leaf, list) else leaf).dtype == torch.bfloat16


def _shape(leaf) -> tuple:
    return (len(leaf), *leaf[0].shape) if isinstance(leaf, list) else tuple(leaf.shape)


def save(ckpt_dir: str, step: int, tree, cfg: ModelConfig | None = None) -> str:
    """Write `tree` (nested dicts of tensors and models; `cfg` is the
    models' config) as checkpoint `step`; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keyed = _flatten(tree, cfg)
    arrays = {k: _array(v) for k, v in keyed.items()}
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape),
                       "dtype": "bfloat16" if _is_bf16(keyed[k]) else str(a.dtype)}
                   for k, a in arrays.items()},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)  # raw-packed
    return torch.from_numpy(np.array(arr)).to(like.dtype)


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like, cfg: ModelConfig | None = None):
    """Restore checkpoint `step` into `like` (the same structure as what was
    saved: a fresh train state, say), leaf by leaf in place on its
    tensors' devices, and return it. Every shape is checked before any
    leaf is written: a mismatch raises ValueError."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    keyed = _flatten(like, cfg)
    with np.load(os.path.join(path, "leaves.npz")) as data:
        missing = [k for k in keyed if k not in data.files]
        if missing:
            raise ValueError(f"leaves {missing} are not in checkpoint {path}")
        arrays = {k: data[k] for k in keyed}
    for k, leaf in keyed.items():
        if arrays[k].shape != _shape(leaf):
            raise ValueError(f"leaf {k}: ckpt shape {arrays[k].shape} != expected {_shape(leaf)}")
    for k, leaf in keyed.items():
        arr = arrays[k]
        rows = leaf if isinstance(leaf, list) else [leaf]
        for r, t in enumerate(rows):
            t.copy_(_tensor(arr[r] if isinstance(leaf, list) else arr, t))
    return like
