"""Mixture-of-Experts with capacity-bounded scatter dispatch.

Top-k routing is a join between the token table and the expert table, and
the dispatch is the group-by rank of the join engine: rank each sequence's
(token, choice) pairs within their expert (cumsum over a one-hot, in
token-major order) and scatter them into per-expert buffers of `cap` rows.
Pairs ranked past an expert's capacity are dropped (the residual carries
their token). Capacity is per sequence.

Supports top-k routing with renormalized gates, capacity factor, and an
optional dense residual branch (snowflake-arctic style).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models import layers, tp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    d_ff: int = 0  # expert hidden size
    capacity_factor: float = 1.25
    dense_residual: bool = False
    d_ff_dense: int = 0  # hidden size of the dense residual branch
    every_n: int = 1  # MoE every n-th layer (jamba: 2)
    act: str = "swiglu"


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype=torch.float32):
    e, f = cfg.num_experts, cfg.d_ff
    p = {
        "router": layers._init_dense(gen, (d_model, e), d_model, torch.float32),
        "wi": layers._init_dense(gen, (e, d_model, f), d_model, dtype),
        "wg": layers._init_dense(gen, (e, d_model, f), d_model, dtype),
        "wo": layers._init_dense(gen, (e, f, d_model), f, dtype),
    }
    if cfg.dense_residual:
        p["dense"] = layers.mlp_init(
            gen, layers.MLPConfig(d_model, cfg.d_ff_dense or 2 * d_model, cfg.act), dtype)
    return p


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, c)


class _ExpertMM(torch.autograd.Function):
    """The expert products, "in": becd,edf->becf and "out": becf,efd->becd,
    with the reference's gradient dtypes: the forward and the activation
    gradient in the buffer's (compute) dtype, the weight gradient
    accumulated in fp32 and then cast to the weight's dtype."""

    @staticmethod
    def forward(ctx, buf, w, sub: str):
        ctx.save_for_backward(buf, w)
        ctx.sub = sub
        return torch.einsum("becd,edf->becf" if sub == "in" else "becf,efd->becd", buf, w)

    @staticmethod
    def backward(ctx, g):
        buf, w = ctx.saved_tensors
        g = g.to(buf.dtype)
        if ctx.sub == "in":
            dbuf = torch.einsum("becf,edf->becd", g, w)
            dw = torch.einsum("becd,becf->edf", buf.float(), g.float())
        else:
            dbuf = torch.einsum("becd,efd->becf", g, w)
            dw = torch.einsum("becf,becd->efd", buf.float(), g.float())
        return dbuf, dw.to(w.dtype), None


def moe_apply(p, cfg: MoEConfig, x: torch.Tensor, experts: tuple[int, int] | None = None):
    """x: (B, S, D). Dispatch groups are the sequences, so capacity is per
    sequence. `experts` = (first, count): p holds only those experts'
    weights, and the result is their share of the combine (an expert-
    parallel shard's)."""
    if isinstance(x, DTensor):
        return tp.moe_apply(moe_apply, p, cfg, x)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(s, cfg)
    dev = x.device

    gates = torch.softmax(x.float() @ p["router"], dim=-1)
    topv, tope = torch.topk(gates, k, dim=-1)  # (B, S, k), descending
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)  # renormalize

    flat_e = tope.reshape(b, s * k)  # token-major order
    pos = torch.cumsum(F.one_hot(flat_e, e), dim=1) - 1  # rank within expert
    pos = pos.gather(2, flat_e[..., None])[..., 0]
    keep = pos < cap
    tok = torch.arange(s, device=dev).repeat_interleave(k)
    bi = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    # row e of the (e + 1)-expert buffer takes the dropped pairs
    buf = torch.zeros((b, e + 1, cap, d), dtype=x.dtype, device=dev)
    buf.index_put_((bi, torch.where(keep, flat_e, e), torch.where(keep, pos, 0)),
                   x[:, tok], accumulate=True)
    first, count = experts or (0, e)
    buf = buf[:, first:first + count]  # (B, E, cap, D)

    h = _ExpertMM.apply(buf, p["wi"].to(x.dtype), "in")
    g = _ExpertMM.apply(buf, p["wg"].to(x.dtype), "in")
    h = F.silu(g) * h if cfg.act == "swiglu" else F.gelu(g, approximate="tanh") * h
    out = _ExpertMM.apply(h, p["wo"].to(x.dtype), "out")  # (B, E, cap, D)

    mine = keep if experts is None else keep & (flat_e >= first) & (flat_e < first + count)
    gathered = out[bi, torch.where(mine, flat_e - first, 0), torch.where(mine, pos, 0)]
    gathered = torch.where(mine[..., None], gathered, 0)
    contrib = (gathered * topv.reshape(b, s * k, 1).to(x.dtype)).reshape(b, s, k, d)
    y = torch.zeros((b, s, d), dtype=x.dtype, device=dev)
    for j in range(k):  # each token's k contributions, added in the reference's order
        y = y + contrib[:, :, j]
    if cfg.dense_residual:
        y = y + layers.mlp_apply(p["dense"], x, cfg.act)
    return y
