"""Core NN layers: plain functions over parameter trees (torch only).

Conventions:
  * a parameter tree is a `Params` module (or any mapping) read like the
    reference's dicts, p["wq"]; init fns take a torch.Generator and return
    plain dicts of tensors, which `Params` wraps.
  * compute dtype is the dtype of the activations passed in; norms and
    softmax run in fp32 and cast back (mixed-precision policy). A weight is
    read through `.to(x.dtype)`, which is free when the caller already
    holds it in the compute dtype (the decode engine casts once).
  * the products follow the reference's einsum layouts, so parameter
    shapes (d, h, hd), (e, d, f), ... are the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn


class Params(nn.Module):
    """One node of a parameter tree: tensors become nn.Parameters, dicts
    child nodes, and p["name"] reads either. Parameters are made with
    requires_grad=False, as serving wants them; a trainer turns gradients
    on with `requires_grad_()`."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            elif isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def keys(self):
        return [*self._parameters, *self._modules]


def map_tree(fn, node) -> nn.Module:
    """A tree of `node`'s structure (Params nodes, ModuleLists) whose
    leaves are fn(leaf), in the same parameter order."""
    if isinstance(node, nn.ModuleList):
        return nn.ModuleList(map_tree(fn, child) for child in node)
    return Params({k: map_tree(fn, node[k]) if isinstance(node[k], nn.Module) else fn(node[k])
                   for k in node.keys()})


def _init_dense(gen: torch.Generator, shape, in_axis_size: int, dtype):
    scale = 1.0 / math.sqrt(in_axis_size)
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return (u.uniform_(-1.0, 1.0, generator=gen) * scale).to(dtype)


def _normal(gen: torch.Generator, shape, dtype):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # the reference's arithmetic, kept so that the rounding matches
    return (y * (1.0 + p["scale"].float() - 1.0)).to(x.dtype) * 1.0


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Rotates halves (x1 | x2), not interleaved pairs."""
    d = x.shape[-1]
    freqs = torch.exp(
        -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d * math.log(theta))
    ang = positions[..., :, None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    act: str = "swiglu"  # swiglu | geglu | gelu


def mlp_init(gen: torch.Generator, cfg: MLPConfig, dtype=torch.float32):
    p = {
        "wi": _init_dense(gen, (cfg.d_model, cfg.d_ff), cfg.d_model, dtype),
        "wo": _init_dense(gen, (cfg.d_ff, cfg.d_model), cfg.d_ff, dtype),
    }
    if cfg.act in ("swiglu", "geglu"):
        p["wg"] = _init_dense(gen, (cfg.d_model, cfg.d_ff), cfg.d_model, dtype)
    return p


def mlp_apply(p, x, act: str = "swiglu"):
    h = x @ p["wi"].to(x.dtype)
    if act == "swiglu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * h
    elif act == "geglu":
        h = F.gelu(x @ p["wg"].to(x.dtype), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32):
    return {"table": _normal(gen, (vocab, d_model), dtype) * 0.02}


def embed_apply(p, tokens: torch.Tensor, compute_dtype):
    # gather, then cast: the same values as casting the whole table first
    return p["table"][tokens].to(compute_dtype)


def unembed_apply(p, x, tied: bool):
    table = p["table"] if tied else p["out"]
    # logits in fp32, (..., vocab)
    return x.float() @ table.float().T
