"""Int8 error-feedback gradient compression for data-parallel all-reduce.

The algebra is the standard EF-SGD scheme: each step quantizes (grad +
error) to int8 with a shared power-of-two-free scale, all-reduces the int8
payload, dequantizes, and carries the quantization residual into the next
step. Over torch.distributed the scale is an all_reduce MAX and the
payload an all_reduce SUM of the int8 values widened to int32 (a sum of
int8s overflows int8); the algebra and the error-feedback state are the
reference's.

Usage in a data-parallel step, in every rank of the group:
    g_global, err = compressed_psum(g_local, err, group)
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compressed_psum(grad: dict, err: dict, group=None):
    """Per-leaf int8 error-feedback mean over the ranks of `group` (default:
    the world).

    grad/err: dicts of tensors (err the same shapes, fp32). Returns
    (mean-reduced fp32 grads, new error state), as dicts."""
    n = dist.get_world_size(group)

    def one(g, e):
        x = g.float() + e
        amax = x.abs().max().reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax[0] / 127.0 + 1e-12
        q = _quantize(x, scale)
        new_err = x - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return total.float() * scale / n, new_err

    outs = {k: one(g, err[k]) for k, g in grad.items()}
    return {k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()}


def init_error(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
