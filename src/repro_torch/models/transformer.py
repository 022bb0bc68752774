"""Composable decoder-only LM covering all 10 assigned architectures.

A model is `num_layers` blocks; block i's mixer type comes from the
repeating `block_pattern` (("attn",) for dense archs, ("attn",) + 7*("mamba",)
for jamba, ("rwkv",) for rwkv6). The FFN of the block at pattern position
`pos` is MoE when `moe.every_n` divides (pos+1). The model is an `LM`
module: `embed`, `final_norm`, and `blocks`, one module per layer, where
layer i = r * len(block_pattern) + pos (repeat r of the pattern unit).
Parameter names and shapes are the reference's pytree paths with its
stacked (R, ...) block leaves unstacked.

Modality frontends ([vlm]/[audio]) are stubs by assignment: `apply_model`
accepts either int token ids (embedded here) or precomputed float
embeddings (B, S, D) (see configs.common.ArchSpec.input_specs).

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`); asking for the card where there is none raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.layers import Params
from repro_torch.models.moe import MoEConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    act: str = "swiglu"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    block_pattern: tuple[str, ...] = ("attn",)
    d_state: int = 16  # mamba
    frontend: str = "none"  # none | vlm | audio (stub: embeddings in)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "none"  # none (recompute all) | dots (save matmul outs)
    attn_q_chunk: int = 1024  # query-chunked attention above this seq len
    scan_unroll: bool = False  # dry-run flops probes unroll the layer scan

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def repeats(self) -> int:
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.num_layers} layers not divisible by pattern {self.block_pattern}"
        )
        return self.num_layers // len(self.block_pattern)

    @property
    def attn_cfg(self) -> attention.AttnConfig:
        return attention.AttnConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.hd,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            sliding_window=self.sliding_window,
        )

    @property
    def mamba_cfg(self) -> ssm.MambaConfig:
        return ssm.MambaConfig(d_model=self.d_model, d_inner=2 * self.d_model, d_state=self.d_state)

    @property
    def rwkv_cfg(self) -> ssm.RWKV6Config:
        return ssm.RWKV6Config(d_model=self.d_model, num_heads=self.num_heads)

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every_n) == (self.moe.every_n - 1)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def resolve_device(device=None) -> torch.device:
    """None -> the card. The CPU runs only when asked for: wanting the card
    where there is none raises instead of carrying on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass device='cpu' to run on the CPU")
    return dev


class LM(Params):
    """The model: Params with `embed`, `final_norm` and `blocks` (an
    nn.ModuleList, one Params per layer)."""

    def __init__(self, embed: dict, final_norm: dict, blocks: list):
        super().__init__({"embed": embed, "final_norm": final_norm,
                          "blocks": nn.ModuleList(Params(b) for b in blocks)})


def _norm_init(cfg: ModelConfig, device):
    init = layers.rmsnorm_init if cfg.norm == "rmsnorm" else layers.layernorm_init
    return init(cfg.d_model, cfg.pdtype(), device)


def _norm_apply(cfg: ModelConfig, p, x):
    return layers.rmsnorm(p, x) if cfg.norm == "rmsnorm" else layers.layernorm(p, x)


def _init_block(gen: torch.Generator, cfg: ModelConfig, pos: int) -> dict:
    """One block at pattern position `pos` (layer index pos within a unit)."""
    kind = cfg.block_pattern[pos]
    dt = cfg.pdtype()
    p = {"ln1": _norm_init(cfg, gen.device), "ln2": _norm_init(cfg, gen.device)}
    if kind == "attn":
        p["mixer"] = attention.attn_init(gen, cfg.attn_cfg, dt)
    elif kind == "mamba":
        p["mixer"] = ssm.mamba_init(gen, cfg.mamba_cfg, dt)
    elif kind == "rwkv":
        p["mixer"] = ssm.rwkv6_init(gen, cfg.rwkv_cfg, dt)
    else:
        raise ValueError(kind)
    if kind == "rwkv":
        p["ffn"] = ssm.rwkv6_ffn_init(gen, cfg.d_model, cfg.d_ff, dt)
    elif cfg.is_moe_layer(pos):
        p["ffn"] = moe.moe_init(gen, cfg.d_model, cfg.moe, dt)
    else:
        p["ffn"] = layers.mlp_init(gen, layers.MLPConfig(cfg.d_model, cfg.d_ff, cfg.act), dt)
    return p


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LM:
    """Random parameters from `seed`, made on `device` (default: the card),
    with the reference's distributions (not its random bits)."""
    if cfg.moe is not None:
        assert len(cfg.block_pattern) % cfg.moe.every_n == 0 or len(cfg.block_pattern) == 1
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed = layers.embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype())
    if not cfg.tie_embeddings:
        embed["out"] = layers._normal(gen, (cfg.vocab, cfg.d_model), cfg.pdtype()) * 0.02
    unit = len(cfg.block_pattern)
    blocks = [_init_block(gen, cfg, i % unit) for i in range(cfg.num_layers)]
    return LM(embed, _norm_init(cfg, dev), blocks)


def _block_apply(cfg: ModelConfig, pos: int, p, x, positions):
    kind = cfg.block_pattern[pos]
    h = _norm_apply(cfg, p["ln1"], x)
    if kind == "attn":
        h = attention.attn_apply(p["mixer"], cfg.attn_cfg, h, positions, cfg.attn_q_chunk)
    elif kind == "mamba":
        h = ssm.mamba_apply(p["mixer"], cfg.mamba_cfg, h)
    else:
        h = ssm.rwkv6_apply(p["mixer"], cfg.rwkv_cfg, h)
    x = x + h
    h = _norm_apply(cfg, p["ln2"], x)
    if kind == "rwkv":
        h_prev = _shift(h)
        h = ssm.rwkv6_ffn(p["ffn"], h, h_prev)
    elif cfg.is_moe_layer(pos):
        h = moe.moe_apply(p["ffn"], cfg.moe, h)
    else:
        h = layers.mlp_apply(p["ffn"], h, cfg.act)
    return x + h


def _shift(h):
    """h shifted right by one position along dim 1, zeros first."""
    if isinstance(h, DTensor):  # some torch releases have no DTensor rule for pad
        return torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return torch.nn.functional.pad(h, (0, 0, 1, 0))[:, :-1]


def _embed(params, cfg: ModelConfig, inputs):
    if inputs.is_floating_point():
        return inputs.to(cfg.cdtype())
    return layers.embed_apply(params["embed"], inputs, cfg.cdtype())


def _unit_apply(cfg: ModelConfig, unit_params, x, positions):
    x = layers.constrain(x, "act")
    for pos, blk in enumerate(unit_params):
        x = _block_apply(cfg, pos, blk, x, positions)
    return x


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" remat policy, the reference's dots_with_no_batch_dims_saveable:
    keep the outputs of 2-D products (`x @ W` on (B, S, D) lowers to mm or
    addmm), recompute everything else, the batched products included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_model(params, cfg: ModelConfig, inputs, positions=None, last_only: bool = False):
    """inputs: int token ids (B, S) or float embeddings (B, S, D).
    Returns fp32 logits (B, S, vocab).

    Runs with autograd where gradients are on. With `cfg.remat` each
    pattern unit of len(block_pattern) layers is then checkpointed, as the
    reference wraps its scanned unit in jax.checkpoint: "none" keeps only
    the unit's input, "dots" also the 2-D products' outputs."""
    x = _embed(params, cfg, inputs)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    unit = len(cfg.block_pattern)
    blocks = list(params["blocks"])
    remat = cfg.remat and torch.is_grad_enabled()
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_dots)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    for r in range(0, len(blocks), unit):
        if remat:
            x = checkpoint(_unit_apply, cfg, blocks[r:r + unit], x, positions,
                           use_reentrant=False, context_fn=context_fn)
        else:
            x = _unit_apply(cfg, blocks[r:r + unit], x, positions)
    x = _norm_apply(cfg, params["final_norm"], x)
    if last_only:
        # serving prefill: only the final position's logits are needed
        x = x[:, -1:]
    return layers.unembed_apply(params["embed"], x, cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# decode path with per-block caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """Cache: tuple over pattern positions; leaves stacked (R, ...), the
    reference's layout. attn -> (k, v); mamba -> (conv_buf, h); rwkv ->
    (x_prev time-mix, x_prev ffn, wkv state)."""
    dtype = dtype or cfg.cdtype()
    dev = resolve_device(device)
    r = cfg.repeats

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    caches = []
    for kind in cfg.block_pattern:
        if kind == "attn":
            w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
            shape = (r, batch, w, cfg.num_kv_heads, cfg.hd)
            caches.append((zeros(shape), zeros(shape)))
        elif kind == "mamba":
            m = cfg.mamba_cfg
            caches.append((zeros((r, batch, m.conv_width - 1, m.d_inner)),
                           zeros((r, batch, m.d_inner, m.d_state), torch.float32)))
        else:
            rc = cfg.rwkv_cfg
            caches.append((zeros((r, batch, 1, cfg.d_model)),
                           zeros((r, batch, 1, cfg.d_model)),
                           zeros((r, batch, rc.num_heads, rc.head_dim, rc.head_dim),
                                 torch.float32)))
    return tuple(caches)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache, cur_len):
    """token (B, 1) int or embedding (B, 1, D); cur_len an int or a () or
    (B,) int tensor. Writes the new state into the cache's tensors in place
    and returns (logits (B, 1, vocab), cache)."""
    x = _embed(params, cfg, token)
    unit = len(cfg.block_pattern)
    for i, p in enumerate(params["blocks"]):
        r, pos = divmod(i, unit)
        kind = cfg.block_pattern[pos]
        if pos == 0:
            x = layers.constrain(x, "act_dec")
        c = [leaf[r] for leaf in cache[pos]]
        h = _norm_apply(cfg, p["ln1"], x)
        if kind == "attn":
            h, _, _ = attention.attn_decode(p["mixer"], cfg.attn_cfg, h, c[0], c[1], cur_len)
        elif kind == "mamba":
            h, buf, hs = ssm.mamba_decode(p["mixer"], cfg.mamba_cfg, h, c[0], c[1])
            c[0].copy_(buf)
            c[1].copy_(hs)
        else:
            h, xp, st = ssm.rwkv6_decode(p["mixer"], cfg.rwkv_cfg, h, c[0], c[2])
        x = x + h
        h2 = _norm_apply(cfg, p["ln2"], x)
        if kind == "rwkv":
            out = ssm.rwkv6_ffn(p["ffn"], h2, c[1])  # reads the old ffn x_prev
            c[0].copy_(xp)
            c[1].copy_(h2)
            c[2].copy_(st)
        elif cfg.is_moe_layer(pos):
            out = moe.moe_apply(p["ffn"], cfg.moe, h2)
        else:
            out = layers.mlp_apply(p["ffn"], h2, cfg.act)
        x = x + out
    x = _norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_apply(params["embed"], x, cfg.tie_embeddings), cache


# ---------------------------------------------------------------------------
# weights held at the dtype they are read at
# ---------------------------------------------------------------------------

# The leaves each block kind reads through `.to(x.dtype)`: the products'
# weights and biases. Norm scales and biases, the router, A_log, D, w0 and
# u are read at their own dtype or in fp32, and stay as they are.
_COMPUTE_READS = {
    "attn": ("wq", "wk", "wv", "wo", "bq", "bk", "bv"),
    "mamba": ("in_proj", "conv", "conv_b", "x_proj", "dt_proj", "dt_bias", "out_proj"),
    "rwkv": ("mu", "wr", "wk", "wv", "wg", "wa", "wb", "wo"),
    "rwkv_ffn": ("mu", "wk", "wv", "wr"),
    "mlp": ("wi", "wg", "wo"),  # also the experts' (E, ...) weights of an MoE
}


def _recast(node, names, dtype) -> dict:
    return {k: (node[k].to(dtype) if k in names else node[k]) for k in node.keys()}


@torch.no_grad()
def compute_params(params: LM, cfg: ModelConfig) -> LM:
    """The same model with every leaf held at the dtype the forward reads it
    at: the products' weights in the compute dtype, the embedding tables in
    fp32 (the unembedding's read; the embedding gathers a row and casts it,
    which gives the same values). A leaf already at that dtype is shared,
    not copied. The logits are the same bits as `params`' own: each read
    of a cast leaf is then a no-op."""
    cdt = cfg.cdtype()
    unit = len(cfg.block_pattern)
    blocks = []
    for i, p in enumerate(params["blocks"]):
        kind = cfg.block_pattern[i % unit]
        ffn = _recast(p["ffn"], _COMPUTE_READS["rwkv_ffn" if kind == "rwkv" else "mlp"], cdt)
        if "dense" in ffn:  # an MoE's dense residual branch
            ffn["dense"] = _recast(ffn["dense"], _COMPUTE_READS["mlp"], cdt)
        blocks.append({"ln1": p["ln1"], "ln2": p["ln2"],
                       "mixer": _recast(p["mixer"], _COMPUTE_READS[kind], cdt), "ffn": ffn})
    embed = _recast(params["embed"], ("table", "out"), torch.float32)
    return LM(embed, params["final_norm"], blocks)
