"""Grouped-query attention with the knobs the assigned archs need:
GQA/MQA kv-head counts, head_dim overrides (gemma: 256), qk-norm (qwen3),
QKV bias (qwen2), sliding windows (mixtral), RoPE theta, causal masking,
and a decode path over a preallocated KV cache.

Shapes: x (B, S, D); q (B, S, H, hd); kv (B, S, Hkv, hd); H % Hkv == 0.
Scores and softmax run in fp32 over scores filled with -1e30 where masked
(a fully masked row comes out uniform, never NaN), as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # None = full causal


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32):
    h, g, d, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.head_dim
    dev = gen.device
    p = {
        "wq": layers._init_dense(gen, (d, h, hd), d, dtype),
        "wk": layers._init_dense(gen, (d, g, hd), d, dtype),
        "wv": layers._init_dense(gen, (d, g, hd), d, dtype),
        "wo": layers._init_dense(gen, (h, hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((g, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((g, hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["qnorm"] = layers.rmsnorm_init(hd, dtype, dev)
        p["knorm"] = layers.rmsnorm_init(hd, dtype, dev)
    return p


def _proj(x, w):
    """x (B, S, D) against w (D, N, hd) -> (B, S, N, hd)."""
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).unflatten(-1, (n, hd))


def _qkv(p, cfg: AttnConfig, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = layers.rmsnorm(p["qnorm"], q)
        k = layers.rmsnorm(p["knorm"], k)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,G,hd), mask (B,S,T). Grouped: fold H into
    (G, H/G), so head h reads kv group h // (H/G)."""
    b, s, h, hd = q.shape
    g = k.shape[2]
    q = q.reshape(b, s, g, h // g, hd)
    scores = torch.einsum("bsgmk,btgk->bgmst", q, k).float()
    scores = scores / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgmst,btgk->bsgmk", probs, v)
    return out.reshape(b, s, h, hd)


def _out(p, out, x):
    h, hd, d = p["wo"].shape
    return out.flatten(-2) @ p["wo"].to(x.dtype).reshape(h * hd, d)


def _causal(i, j, cfg: AttnConfig):
    mask = j <= i
    if cfg.sliding_window is not None:
        mask = mask & (j > i - cfg.sliding_window)
    return mask


def attn_apply(p, cfg: AttnConfig, x, positions, q_chunk: int = 0):
    """Full-sequence causal attention (train / prefill).

    With q_chunk > 0 and seq divisible, queries are processed in chunks of
    q_chunk rows: peak score memory drops from O(S^2) to O(q_chunk * S)
    per head, which sets the peak memory of a long prefill."""
    q, k, v = _qkv(p, cfg, x, positions)
    b, s = x.shape[:2]
    j = torch.arange(s, device=x.device)[None, :]
    if q_chunk and s > q_chunk and s % q_chunk == 0:
        outs = []
        for c in range(s // q_chunk):
            i = c * q_chunk + torch.arange(q_chunk, device=x.device)[:, None]
            mask = _causal(i, j, cfg).expand(b, q_chunk, s)
            outs.append(_sdpa(q[:, c * q_chunk:(c + 1) * q_chunk], k, v, mask))
        out = torch.cat(outs, dim=1)
    else:
        i = torch.arange(s, device=x.device)[:, None]
        out = _sdpa(q, k, v, _causal(i, j, cfg).expand(b, s, s))
    return _out(p, out, x)


def attn_decode(p, cfg: AttnConfig, x, cache_k, cache_v, cur_len):
    """One-token decode. x (B, 1, D); cache_k/v (B, T, G, hd); cur_len an
    int, or a () or (B,) int tensor = per-sequence number of valid cache
    positions (the vector form serves continuous batching of mixed-length
    requests). Writes the new token's k/v into cache_k/cache_v in place and
    returns (out, cache_k, cache_v).

    With a sliding window the cache is a rotating buffer of window size W:
    the new token overwrites slot cur_len % W."""
    b = x.shape[0]
    t = cache_k.shape[1]
    if isinstance(cur_len, int):
        cur = torch.full((b,), cur_len, dtype=torch.int32, device=x.device)
    else:
        cur = cur_len.to(torch.int32).expand(b)
    q, k, v = _qkv(p, cfg, x, cur[:, None])  # RoPE at absolute positions
    slot = cur % t if cfg.sliding_window is not None else cur.clamp(max=t - 1)
    bi = torch.arange(b, device=x.device)
    cache_k[bi, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[bi, slot] = v[:, 0].to(cache_v.dtype)
    j = torch.arange(t, device=x.device)[None, :]
    valid = j <= slot[:, None]
    if cfg.sliding_window is not None:
        valid = valid | (cur[:, None] >= t)  # full rotating buffer
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), valid[:, None, :])
    return _out(p, out, x), cache_k, cache_v
