"""State-space & linear-attention blocks: Mamba (jamba's SSM half) and
RWKV-6 "Finch" (data-dependent decay).

Both carry O(1) per-step state, so decode is sub-quadratic in context:
  * Mamba: selective SSM. Full-seq path = a loop over chunks carrying the
    (B, d_inner, N) state, with a log-step (Hillis-Steele) scan in tensor
    ops inside each chunk (bounded transients instead of a (B, S, d_inner,
    N) blow-up).
  * RWKV-6: per-head matrix state S (hd x hd) with data-dependent diagonal
    decay w_t = exp(-exp(...)), token-shift mixing, bonus u, per-head
    group-norm. Full-seq path = a loop over time with an fp32 state;
    decode carries (x_prev, S) only.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int  # usually 2 * d_model
    d_state: int = 16
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    conv_width: int = 4
    chunk: int = 256

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, math.ceil(self.d_model / 16))


def mamba_init(gen: torch.Generator, cfg: MambaConfig, dtype=torch.float32):
    di, n, r = cfg.d_inner, cfg.d_state, cfg.rank
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(di, 1)
    return {
        "in_proj": layers._init_dense(gen, (cfg.d_model, 2 * di), cfg.d_model, dtype),
        "conv": layers._init_dense(gen, (cfg.conv_width, di), cfg.conv_width, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": layers._init_dense(gen, (di, r + 2 * n), di, dtype),
        "dt_proj": layers._init_dense(gen, (r, di), r, dtype),
        "dt_bias": torch.zeros((di,), dtype=dtype, device=dev),
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": layers._init_dense(gen, (di, cfg.d_model), di, dtype),
    }


def _linear_scan(a, b):
    """Inclusive scan along dim 1 of h_t = a_t * h_{t-1} + b_t from h = 0,
    as (a, b) pairs under (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2), in
    log2(n) whole-tensor steps."""
    step = 1
    while step < a.shape[1]:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return a, b


def _mamba_scan(da, dbx, cfg: MambaConfig):
    """da, dbx: (B, S, di, N) decay and input terms. Chunked linear scan:
    h_t = da_t * h_{t-1} + dbx_t. Returns h over all t."""
    b, s, di, n = da.shape
    ck = min(cfg.chunk, s)
    nc = s // ck
    assert nc * ck == s, f"seq {s} must be divisible by chunk {ck}"
    h0 = torch.zeros((b, di, n), dtype=da.dtype, device=da.device)
    hs = []
    for c in range(nc):
        aa, bb = _linear_scan(da[:, c * ck:(c + 1) * ck], dbx[:, c * ck:(c + 1) * ck])
        h = aa * h0[:, None] + bb  # (B, ck, di, N)
        h0 = h[:, -1]
        hs.append(h)
    return torch.cat(hs, dim=1)


def _dt(p, cfg: MambaConfig, xi):
    """x_proj of the conv output, split into (softplus'd fp32 dt, B, C)."""
    dbc = xi @ p["x_proj"].to(xi.dtype)
    dt, bmat, cmat = torch.split(dbc, [cfg.rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(xi.dtype) + p["dt_bias"].to(xi.dtype)).float()
    return dt, bmat, cmat


def mamba_apply(p, cfg: MambaConfig, x):
    """x: (B, S, D) -> (B, S, D)."""
    s = x.shape[1]
    xi, z = (x @ p["in_proj"].to(x.dtype)).chunk(2, dim=-1)  # (B, S, di)
    # causal depthwise conv, window w
    w = cfg.conv_width
    pad = F.pad(xi, (0, 0, w - 1, 0))
    conv = pad[:, 0:s] * p["conv"][0].to(x.dtype)
    for i in range(1, w):
        conv = conv + pad[:, i:i + s] * p["conv"][i].to(x.dtype)
    xi = F.silu(conv + p["conv_b"].to(x.dtype))
    dt, bmat, cmat = _dt(p, cfg, xi)
    a = -torch.exp(p["A_log"])  # (di, N)
    da = torch.exp(dt[..., None] * a)  # (B, S, di, N)
    dbx = (dt * xi.float())[..., None] * bmat.float()[..., None, :]
    h = _mamba_scan(da.float(), dbx, cfg)
    y = torch.einsum("bsin,bsn->bsi", h, cmat.float())
    y = (y + p["D"] * xi.float()).to(x.dtype)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


def mamba_decode(p, cfg: MambaConfig, x, conv_buf, h):
    """One-step decode. x (B, 1, D); conv_buf (B, w-1, di); h (B, di, N).
    Returns (y, conv_buf, h), the last two new tensors."""
    xi, z = (x @ p["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    window = torch.cat([conv_buf, xi], dim=1)  # (B, w, di)
    conv = torch.einsum("bwi,wi->bi", window, p["conv"].to(x.dtype)) + p["conv_b"].to(x.dtype)
    xi1 = F.silu(conv)[:, None]  # (B, 1, di)
    dt, bmat, cmat = _dt(p, cfg, xi1)
    dt = dt[:, 0]
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a)  # (B, di, N)
    dbx = (dt * xi1[:, 0].float())[..., None] * bmat.float()[:, 0][:, None, :]
    h = da * h + dbx
    y = torch.einsum("bin,bn->bi", h, cmat.float()[:, 0])
    y = (y + p["D"] * xi1[:, 0].float()).to(x.dtype)
    y = y * F.silu(z[:, 0])
    out = (y @ p["out_proj"].to(x.dtype))[:, None]
    return out, window[:, 1:], h


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    num_heads: int  # head_dim = d_model // num_heads
    decay_lora: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def rwkv6_init(gen: torch.Generator, cfg: RWKV6Config, dtype=torch.float32):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    dev = gen.device
    return {
        "mu": 0.5 * torch.ones((5, d), dtype=dtype, device=dev),  # mixes for r,k,v,w,g
        "wr": layers._init_dense(gen, (d, d), d, dtype),
        "wk": layers._init_dense(gen, (d, d), d, dtype),
        "wv": layers._init_dense(gen, (d, d), d, dtype),
        "wg": layers._init_dense(gen, (d, d), d, dtype),
        "w0": torch.zeros((d,), dtype=torch.float32, device=dev) - 4.0,  # base decay
        "wa": layers._init_dense(gen, (d, cfg.decay_lora), d, dtype),
        "wb": layers._init_dense(gen, (cfg.decay_lora, d), cfg.decay_lora, dtype),
        "u": torch.zeros((h, hd), dtype=torch.float32, device=dev),  # bonus
        "wo": layers._init_dense(gen, (d, d), d, dtype),
        "ln_x": layers.layernorm_init(hd, dtype, dev),  # per-head group norm
    }


def _rwkv6_proj(p, cfg: RWKV6Config, x, x_prev):
    """Token-shifted projections. x, x_prev: (B, S, D) where x_prev is x
    shifted right by one (or the carried last token in decode)."""
    mu = p["mu"].to(x.dtype)
    mix = [x + mu[i] * (x_prev - x) for i in range(5)]
    r = mix[0] @ p["wr"].to(x.dtype)
    k = mix[1] @ p["wk"].to(x.dtype)
    v = mix[2] @ p["wv"].to(x.dtype)
    # data-dependent decay (the Finch headline): w_t = exp(-exp(w0 + lora))
    lora = torch.tanh(mix[3]) @ p["wa"].to(x.dtype) @ p["wb"].to(x.dtype)
    w = torch.exp(-torch.exp(p["w0"] + lora.float()))  # (B,S,D) in (0,1)
    g = F.silu(mix[4] @ p["wg"].to(x.dtype))
    b, s, _ = x.shape
    shp = (b, s, cfg.num_heads, cfg.head_dim)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _wkv_step(state, r, k, v, w, u):
    """state (B, H, hd, hd); r,k,v,w (B, H, hd). Returns (state, out (B, H, hd))."""
    kv = k[..., :, None] * v[..., None, :]  # (B,H,hd,hd)
    out = torch.einsum("bhk,bhkv->bhv", r, state + u[..., :, None] * kv)
    return w[..., :, None] * state + kv, out


def _rwkv6_out(p, x, out, g):
    b, s, d = x.shape
    out = layers.layernorm(p["ln_x"], out.to(x.dtype))
    out = (out.reshape(b, s, d) * g.reshape(b, s, d)).to(x.dtype)
    return out @ p["wo"].to(x.dtype)


def rwkv6_apply(p, cfg: RWKV6Config, x):
    """x: (B, S, D) -> (B, S, D). Sequential loop over time."""
    b, s, _ = x.shape
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g = _rwkv6_proj(p, cfg, x, x_prev)
    r, k, v, w = r.float(), k.float(), v.float(), w.float()
    hd = cfg.head_dim
    state = torch.zeros((b, cfg.num_heads, hd, hd), dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        state, o = _wkv_step(state, r[:, t], k[:, t], v[:, t], w[:, t], p["u"])
        outs.append(o)
    return _rwkv6_out(p, x, torch.stack(outs, dim=1), g)  # (B, S, H, hd) in


def rwkv6_decode(p, cfg: RWKV6Config, x, x_prev, state):
    """One-step decode. x (B, 1, D); x_prev (B, 1, D); state (B,H,hd,hd).
    Returns (out, new_x_prev, new_state)."""
    r, k, v, w, g = _rwkv6_proj(p, cfg, x, x_prev)
    state, out = _wkv_step(state, r[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
                           w[:, 0].float(), p["u"])
    return _rwkv6_out(p, x, out[:, None], g), x, state


def rwkv6_ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "mu": 0.5 * torch.ones((2, d_model), dtype=dtype, device=gen.device),
        "wk": layers._init_dense(gen, (d_model, d_ff), d_model, dtype),
        "wv": layers._init_dense(gen, (d_ff, d_model), d_ff, dtype),
        "wr": layers._init_dense(gen, (d_model, d_model), d_model, dtype),
    }


def rwkv6_ffn(p, x, x_prev):
    mu = p["mu"].to(x.dtype)
    xk = x + mu[0] * (x_prev - x)
    xr = x + mu[1] * (x_prev - x)
    k = torch.square(F.relu(xk @ p["wk"].to(x.dtype)))
    kv = k @ p["wv"].to(x.dtype)
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    return r * kv
