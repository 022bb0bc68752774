"""AdamW with warmup+cosine schedule, global-norm clipping, and a
configurable moment dtype (bf16 moments for the >=398B archs so optimizer
state fits device memory). No torch.optim: the update is the reference's
arithmetic, leaf by leaf, in place on the model's parameters.

Parameters are a model (`repro_torch.models.transformer.LM`, one module
per layer); the moments are trees of the same structure
(`layers.map_tree`), so a checkpoint re-stacks them as it does the
parameters; gradients are a sequence in `params.parameters()` order.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.models.layers import map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    moment_dtype: str = "float32"


def moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at `step` (an int or an int tensor): linear warmup,
    then cosine down to min_lr_frac * lr at total_steps."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(cfg: AdamWConfig, params: nn.Module) -> dict:
    """{"step": int32 0-d tensor, "m", "v": zero trees of params' structure
    in the moment dtype}, on params' device."""
    dt = moment_dtype(cfg)
    device = next(params.parameters()).device

    def zeros(p):
        return torch.zeros_like(p, dtype=dt)  # a DTensor's zeros keep its placements

    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": map_tree(zeros, params), "v": map_tree(zeros, params)}


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a tensor over a tensor: `max_norm / gn` would multiply by gn's reciprocal
    return torch.clamp(torch.full_like(gn, max_norm) / torch.clamp(gn, min=1e-9), max=1.0)


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global fp32 norm is at most max_norm, each in
    its own dtype; the norm before clipping)."""
    grads = list(grads)
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return [_clip(g, scale) for g in grads], gn


def decays(name: str, p: torch.Tensor) -> bool:
    """Decoupled weight decay on the reference's matrices: its leaves with
    ndim >= 2. Its block leaves are stacked (R, ...), so every block leaf
    of this port's per-layer modules (a norm scale or bias of shape (d,)
    included) is one there."""
    return p.ndim >= (1 if name.startswith("blocks.") else 2)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: nn.Module, grads, state: dict):
    """One AdamW step, in place on `params` and the state's moments.
    Returns (params, state, metrics), metrics {"lr", "grad_norm"} as
    tensors on the device (nothing is read back)."""
    grads = list(grads)
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    dt = moment_dtype(cfg)
    for (name, p), g, m, v in zip(params.named_parameters(), grads, state["m"].parameters(),
                                  state["v"].parameters()):
        gf = _clip(g, scale).float()  # clipped leaf by leaf: no second copy of every grad
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if decays(name, p):
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        m.copy_(mf.to(dt))
        v.copy_(vf.to(dt))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
