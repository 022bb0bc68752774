"""Sharding rules: param path + shape -> PartitionSpec on the production
mesh, and the spec as DTensor placements.

Policy (the reference's baseline):
  * tensor parallelism over "model": prefer head/expert/ffn dims; fall back
    to any dim the axis divides (sharding propagation inserts the reduction
    collectives for row-parallel layouts).
  * FSDP over "data": after TP assignment, shard the largest remaining
    divisible dim of every >=2D param (params + Adam moments). The "pod"
    axis stays pure DP (gradient all-reduce only crosses pods — the slow
    boundary moves bytes once per step, not per layer).
  * batch dims of inputs/caches over ("pod","data"); long-context decode
    (batch=1) shards the KV time axis over "data" instead.

The reference stacks a block leaf (R, ...) under its pattern position and
shifts its rules by one dim; this port holds one module per layer
(`blocks.17.mixer.wq` is (D, H, hd)), so a block leaf gets the reference's
spec of its stacked leaf with the leading (never sharded) None dropped.
The decode caches are stacked (R, B, ...) in both packages, so
`cache_spec` is the reference's unchanged.
"""
from __future__ import annotations

import math
import re

from torch import nn
from torch.distributed.tensor import Replicate, Shard


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of
    names (sharded over their product, the first outermost)."""

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as JAX normalizes it
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or of any object with the
    reference's `axis_names` and `shape` mapping (a stub mesh)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


# (path regex, preferred dims for "model") — dims are for the per-layer param
_TP_PREFS: list[tuple[str, list[int]]] = [
    (r"embed.*(table|out)", [0]),  # (V, D): vocab-parallel
    (r"mixer.*w[q]", [1, 2, 0]),  # (D, H, hd)
    (r"mixer.*w[kv]$", [1, 2, 0]),  # (D, G, hd)
    (r"mixer.*wo", [0, 2, 1]),  # (H, hd, D)
    (r"(ffn|dense).*w[ig]$", [1, 0]),  # (D, F) col-parallel
    (r"(ffn|dense).*wo$", [0, 1]),  # (F, D) row-parallel
    (r"ffn.*router", []),  # replicate router
    (r"mixer.*(in_proj)", [1, 0]),  # mamba (D, 2di)
    (r"mixer.*(x_proj)", [0, 1]),  # (di, r+2n)
    (r"mixer.*(dt_proj)", [1, 0]),
    (r"mixer.*(out_proj)", [0, 1]),
    (r"mixer.*(A_log)", [0]),
    (r"mixer.*conv$", [1]),
    (r"mixer.*w[rg]$", [1, 0]),  # rwkv (D, D)
    (r"mixer.*(wa|wb)", [0, 1]),
]

# MoE experts: (E, D, F)/(E, F, D) — expert-parallel first, then ffn dim
_TP_PREFS.insert(0, (r"ffn.*w[ig]$__3d", [0, 2, 1]))
_TP_PREFS.insert(0, (r"ffn.*wo$__3d", [0, 1, 2]))


def _prefs_for(path: str, ndim: int) -> list[int]:
    for pat, dims in _TP_PREFS:
        if pat.endswith("__3d"):
            if ndim == 3 and re.search(pat[: -len("__3d")], path):
                return dims
            continue
        if re.search(pat, path):
            return dims
    return list(range(ndim))  # no named rule: any divisible dim


def param_spec(path: str, shape: tuple[int, ...], mesh) -> P:
    """TP + FSDP spec for one param leaf. `path` is a dotted parameter name
    ("blocks.17.ffn.wi"; any non-word separators are normalized to dots),
    so the rule regexes can anchor on leaf names."""
    path = ".".join(re.findall(r"\w+", path))
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1)
    off = 0  # the reference's offset of a stacked (R, ...) leaf: none here
    ndim = len(shape)
    if ndim - off < 1:
        return P()
    spec: list = [None] * ndim

    # attention projections shard on the *heads* dim or not at all:
    # falling back to head_dim makes QK^T contract a sharded-vs-unsharded
    # (or doubly-sharded) dim, hence per-layer fp32 score all-reduces.
    if re.search(r"mixer.*(wq|wk|wv)$", path) and ndim - off == 3:
        if shape[off + 1] % model_n == 0 and shape[off + 1] >= model_n:
            spec[off + 1] = "model"
        if shape[off] % data_n == 0:
            spec[off] = "data"
        return P(*spec)
    if re.search(r"mixer.*wo$", path) and ndim - off == 3:
        if shape[off] % model_n == 0 and shape[off] >= model_n:
            spec[off] = "model"
        if shape[off + 2] % data_n == 0:
            spec[off + 2] = "data"
        return P(*spec)

    # MoE expert weights: expert-parallel when E divides the model axis,
    # otherwise ffn-dim tensor parallel + FSDP over data on the other dim.
    if re.search(r"ffn.*(wi|wg|wo)$", path) and ndim - off == 3:
        fdim = off + 2 if re.search(r"w[ig]$", path) else off + 1
        other = off + 1 if fdim == off + 2 else off + 2
        if shape[off] % model_n == 0 and shape[off] >= model_n:
            spec[off] = "model"
            rest = [d for d in (off + 1, off + 2) if shape[d] % data_n == 0]
            if rest:
                spec[max(rest, key=lambda i: shape[i])] = "data"
        elif shape[fdim] % model_n == 0:
            spec[fdim] = "model"
            if shape[other] % data_n == 0:
                spec[other] = "data"
        return P(*spec)

    body = list(range(off, ndim))
    prefs = [d + off for d in _prefs_for(path, ndim - off)]
    # tensor parallel over "model"
    tp_dim = None
    for d in prefs:
        if d < ndim and shape[d] % model_n == 0 and shape[d] >= model_n:
            spec[d] = "model"
            tp_dim = d
            break
    # FSDP over "data": largest remaining divisible dim
    if ndim - off >= 2 or tp_dim is None:
        cands = [d for d in body if d != tp_dim and shape[d] % data_n == 0 and shape[d] >= data_n]
        if cands:
            d = max(cands, key=lambda i: shape[i])
            spec[d] = "data"
    return P(*spec)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim: Shard(d)
    where the spec names that mesh dim's axis on tensor dim d, Replicate()
    elsewhere. A tuple entry shards its dim over each named axis, in mesh
    order (pod outer), as JAX orders it."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(model: nn.Module, mesh) -> dict:
    """{parameter name: (mesh, placements)} for every leaf of `model`."""
    return {name: (mesh, placements(param_spec(name, tuple(p.shape), mesh), mesh))
            for name, p in model.named_parameters()}


def batch_spec(shape: tuple[int, ...], mesh) -> P:
    """Inputs (B, S[, D]): batch over (pod, data) when divisible; batch=1
    long-context shards the sequence dim over data instead."""
    sizes = _axis_sizes(mesh)
    dp = [a for a in ("pod", "data") if a in sizes]
    dp_n = math.prod(sizes[a] for a in dp)
    if shape[0] % dp_n == 0 and shape[0] >= dp_n:
        return P(dp[0] if len(dp) == 1 else tuple(dp), *([None] * (len(shape) - 1)))
    if shape[0] % sizes.get("data", 1) == 0 and shape[0] >= sizes.get("data", 1):
        return P("data", *([None] * (len(shape) - 1)))
    if len(shape) > 1 and shape[1] % sizes.get("data", 1) == 0:
        return P(None, "data", *([None] * (len(shape) - 2)))
    return P(*([None] * len(shape)))


def cache_spec(shape: tuple[int, ...], mesh) -> P:
    """Decode caches, stacked (R, B, T, ...) or (R, B, ...): batch over
    (pod,data) if divisible else time over data; heads over model."""
    sizes = _axis_sizes(mesh)
    dp = [a for a in ("pod", "data") if a in sizes]
    dp_n = math.prod(sizes[a] for a in dp)
    data_n = sizes.get("data", 1)
    model_n = sizes.get("model", 1)
    spec: list = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dp_n == 0 and shape[1] >= dp_n:
        spec[1] = dp[0] if len(dp) == 1 else tuple(dp)
    elif len(shape) >= 3 and shape[2] % data_n == 0 and shape[2] >= data_n:
        spec[2] = "data"  # shard KV time axis (long-context, batch=1)
    # shard a heads/feature dim over model: prefer dims after time
    for d in range(len(shape) - 1, 1, -1):
        if spec[d] is None and shape[d] % model_n == 0 and shape[d] >= model_n:
            spec[d] = "model"
            break
    return P(*spec)


def cache_shardings(cache, mesh) -> tuple:
    """(mesh, placements) for every leaf of a decode cache, in its
    structure (a tuple over pattern positions of tuples of leaves)."""
    return tuple(tuple((mesh, placements(cache_spec(tuple(leaf.shape), mesh), mesh))
                       for leaf in pos) for pos in cache)
