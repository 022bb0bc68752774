"""The port's model layers (repro_torch.models) against the reference's, one
module at a time, on the CPU: the same parameters (the reference's init,
with its zero biases and unit norm scales replaced by random values so they
count) and the same inputs, made from a seed with numpy.

fp32 at rtol = atol = 1e-5; attention and the MLP also at a bfloat16
compute dtype, at 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import ssm as r_ssm
from repro_torch.models import attention as p_attn
from repro_torch.models import layers as p_layers
from repro_torch.models import moe as p_moe
from repro_torch.models import ssm as p_ssm

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def randomized(tree, seed: int):
    """The reference's parameter tree as numpy, with constant leaves (zero
    biases, unit scales) replaced by random ones."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, tree))
    out = []
    for a in leaves:
        if a.size > 1 and np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree.unflatten(treedef, out)


def jit(fn, *static):
    """The reference function compiled once (its eager dispatch is slower)."""
    return jax.jit(fn, static_argnums=static)


def ref_tree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def port_tree(np_tree):
    return p_layers.Params(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_tree))


def t(a):
    return torch.from_numpy(np.asarray(a))


def x_of(seed: int, shape, scale: float = 1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# norms, rope, MLPs, embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    d = 48
    p = randomized(getattr(r_layers, f"{norm}_init")(d), 0)
    x = x_of(1, (2, 5, d), 3.0)
    want = jit(getattr(r_layers, norm))(ref_tree(p), jnp.asarray(x))
    close(getattr(p_layers, norm)(port_tree(p), t(x)), want)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    x = x_of(2, (2, 7, 3, 16))
    pos = np.random.default_rng(3).integers(0, 4000, (2, 7)).astype(np.int32)
    want = jit(r_layers.rope, 2)(jnp.asarray(x), jnp.asarray(pos), theta)
    close(p_layers.rope(t(x), t(pos), theta), want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp(act):
    cfg = r_layers.MLPConfig(32, 80, act)
    p = randomized(r_layers.mlp_init(jax.random.PRNGKey(0), cfg), 1)
    x = x_of(4, (2, 5, 32))
    want = jit(r_layers.mlp_apply, 2)(ref_tree(p), jnp.asarray(x), act)
    close(p_layers.mlp_apply(port_tree(p), t(x), act), want)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed(tied):
    vocab, d = 96, 32
    p = r_layers.embed_init(jax.random.PRNGKey(0), vocab, d)
    if not tied:
        p["out"] = jax.random.normal(jax.random.PRNGKey(1), (vocab, d)) * 0.02
    p = jax.tree.map(np.asarray, p)
    toks = np.random.default_rng(5).integers(0, vocab, (3, 6)).astype(np.int32)
    for cdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = r_layers.embed_apply(ref_tree(p), jnp.asarray(toks), cdt)
        got = p_layers.embed_apply(port_tree(p), t(toks), pdt)
        assert got.dtype == pdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    x = x_of(6, (3, 6, d))
    want = r_layers.unembed_apply(ref_tree(p), jnp.asarray(x), tied)
    got = p_layers.unembed_apply(port_tree(p), t(x), tied)
    assert got.dtype == torch.float32 and got.shape == (3, 6, vocab)
    close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = {
    "gqa": dict(num_heads=4, num_kv_heads=2, head_dim=16),
    "mqa": dict(num_heads=4, num_kv_heads=1, head_dim=24),
    "qknorm_bias": dict(num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True, qkv_bias=True,
                        rope_theta=1e6),
    "window": dict(num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=5),
}


def attn_case(name, d: int = 32):
    cfg_kw = dict(d_model=d, **ATTN[name])
    rcfg, pcfg = r_attn.AttnConfig(**cfg_kw), p_attn.AttnConfig(**cfg_kw)
    p = randomized(r_attn.attn_init(jax.random.PRNGKey(7), rcfg), 8)
    return rcfg, pcfg, p


@pytest.mark.parametrize("name,q_chunk", [("gqa", 0), ("mqa", 0), ("qknorm_bias", 0),
                                          ("window", 0), ("gqa", 4), ("window", 4)])
def test_attn_apply(name, q_chunk):
    rcfg, pcfg, p = attn_case(name)
    b, s = 2, 12
    x = x_of(9, (b, s, 32))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = jit(r_attn.attn_apply, 1, 4)(ref_tree(p), rcfg, jnp.asarray(x), jnp.asarray(pos),
                                        q_chunk)
    close(p_attn.attn_apply(port_tree(p), pcfg, t(x), t(pos.copy()), q_chunk), want)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_attn_decode_rotating(name):
    """Ten decode steps over a cache of 5 positions: with a sliding window
    the buffer wraps twice; without one the last slot is rewritten."""
    rcfg, pcfg, p = attn_case(name)
    b, t_len, g, hd = 3, 5, 2, 16
    rk = rv = jnp.zeros((b, t_len, g, hd))
    pk, pv = torch.zeros((b, t_len, g, hd)), torch.zeros((b, t_len, g, hd))
    xs = x_of(10, (10, b, 1, 32))
    decode = jit(r_attn.attn_decode, 1)
    for step in range(10):
        cur = np.array([step, max(0, step - 3), 2 * step], np.int32)
        want, rk, rv = decode(ref_tree(p), rcfg, jnp.asarray(xs[step]), rk, rv, jnp.asarray(cur))
        got, pk, pv = p_attn.attn_decode(port_tree(p), pcfg, t(xs[step]), pk, pv, t(cur))
        close(got, want)
        close(pk, rk)
        close(pv, rv)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_attn_bf16(name):
    rcfg, pcfg, p = attn_case(name)
    b, s = 2, 10
    x = x_of(11, (b, s, 32))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    want = jit(r_attn.attn_apply, 1)(ref_tree(p), rcfg, jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(pos))
    got = p_attn.attn_apply(port_tree(p), pcfg, t(x).bfloat16(), t(pos))
    assert got.dtype == torch.bfloat16
    close(got, want, BF16_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_bf16(act):
    cfg = r_layers.MLPConfig(32, 80, act)
    p = randomized(r_layers.mlp_init(jax.random.PRNGKey(0), cfg), 1)
    x = x_of(12, (2, 5, 32))
    want = jit(r_layers.mlp_apply, 2)(ref_tree(p), jnp.asarray(x, jnp.bfloat16), act)
    got = p_layers.mlp_apply(port_tree(p), t(x).bfloat16(), act)
    assert got.dtype == torch.bfloat16
    close(got, want, BF16_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dense_residual", [False, True])
def test_moe_drops_tokens(dense_residual):
    """capacity_factor 0.5: an expert keeps max(4, 16 * 2 * 0.5 / 4) = 4 of
    the 8 pairs it gets on average, so tokens are dropped."""
    kw = dict(num_experts=4, top_k=2, d_ff=48, capacity_factor=0.5,
              dense_residual=dense_residual, d_ff_dense=40)
    rcfg, pcfg = r_moe.MoEConfig(**kw), p_moe.MoEConfig(**kw)
    p = randomized(r_moe.moe_init(jax.random.PRNGKey(3), 32, rcfg), 4)
    x = x_of(13, (2, 16, 32))
    # the test's premise: some (token, choice) pairs rank past the capacity
    tope = np.argsort(-(x @ p["router"]), axis=-1)[..., :2].reshape(2, -1)
    assert max(np.bincount(row, minlength=4).max() for row in tope) > r_moe._capacity(16, rcfg)
    want = jit(r_moe.moe_apply, 1)(ref_tree(p), rcfg, jnp.asarray(x))
    close(p_moe.moe_apply(port_tree(p), pcfg, t(x)), want)


def test_moe_capacity_rule():
    for tokens, cf in ((1, 1.25), (16, 0.5), (100, 1.25), (4096, 1.0), (7, 8.0)):
        kw = dict(num_experts=8, top_k=2, capacity_factor=cf)
        assert p_moe._capacity(tokens, p_moe.MoEConfig(**kw)) == \
            r_moe._capacity(tokens, r_moe.MoEConfig(**kw))


# ---------------------------------------------------------------------------
# SSMs
# ---------------------------------------------------------------------------


def mamba_case():
    kw = dict(d_model=24, d_inner=48, d_state=8, chunk=4)
    rcfg, pcfg = r_ssm.MambaConfig(**kw), p_ssm.MambaConfig(**kw)
    p = randomized(r_ssm.mamba_init(jax.random.PRNGKey(5), rcfg), 6)
    return rcfg, pcfg, p


def test_mamba_apply_chunked():
    rcfg, pcfg, p = mamba_case()
    x = x_of(14, (2, 16, 24))  # 4 chunks of 4
    want = jit(r_ssm.mamba_apply, 1)(ref_tree(p), rcfg, jnp.asarray(x))
    close(p_ssm.mamba_apply(port_tree(p), pcfg, t(x)), want)
    with pytest.raises(AssertionError, match="divisible"):
        p_ssm.mamba_apply(port_tree(p), pcfg, t(x[:, :10]))


def test_mamba_decode():
    rcfg, pcfg, p = mamba_case()
    b = 2
    r_buf, r_h = jnp.zeros((b, 3, 48)), jnp.zeros((b, 48, 8))
    p_buf, p_h = torch.zeros((b, 3, 48)), torch.zeros((b, 48, 8))
    xs = x_of(15, (6, b, 1, 24))
    decode = jit(r_ssm.mamba_decode, 1)
    for step in range(6):
        want, r_buf, r_h = decode(ref_tree(p), rcfg, jnp.asarray(xs[step]), r_buf, r_h)
        got, p_buf, p_h = p_ssm.mamba_decode(port_tree(p), pcfg, t(xs[step]), p_buf, p_h)
        close(got, want)
        close(p_buf, r_buf)
        close(p_h, r_h)


def rwkv_case():
    rcfg, pcfg = r_ssm.RWKV6Config(32, 4, decay_lora=8), p_ssm.RWKV6Config(32, 4, decay_lora=8)
    p = randomized(r_ssm.rwkv6_init(jax.random.PRNGKey(9), rcfg), 10)
    return rcfg, pcfg, p


def test_rwkv6_apply():
    rcfg, pcfg, p = rwkv_case()
    x = x_of(16, (2, 9, 32))
    want = jit(r_ssm.rwkv6_apply, 1)(ref_tree(p), rcfg, jnp.asarray(x))
    close(p_ssm.rwkv6_apply(port_tree(p), pcfg, t(x)), want)


def test_rwkv6_decode():
    rcfg, pcfg, p = rwkv_case()
    b = 2
    r_prev, r_st = jnp.zeros((b, 1, 32)), jnp.zeros((b, 4, 8, 8))
    p_prev, p_st = torch.zeros((b, 1, 32)), torch.zeros((b, 4, 8, 8))
    xs = x_of(17, (5, b, 1, 32))
    decode = jit(r_ssm.rwkv6_decode, 1)
    for step in range(5):
        want, r_prev, r_st = decode(ref_tree(p), rcfg, jnp.asarray(xs[step]),
                                                r_prev, r_st)
        got, p_prev, p_st = p_ssm.rwkv6_decode(port_tree(p), pcfg, t(xs[step]), p_prev, p_st)
        close(got, want)
        close(p_prev, r_prev)
        close(p_st, r_st)


def test_rwkv6_ffn():
    p = randomized(r_ssm.rwkv6_ffn_init(jax.random.PRNGKey(11), 32, 72), 12)
    x, x_prev = x_of(18, (2, 5, 32)), x_of(19, (2, 5, 32))
    want = jit(r_ssm.rwkv6_ffn)(ref_tree(p), jnp.asarray(x), jnp.asarray(x_prev))
    close(p_ssm.rwkv6_ffn(port_tree(p), t(x), t(x_prev)), want)


def test_config_fields_match():
    """The per-module config dataclasses carry the reference's fields and
    defaults."""
    for rc, pc in ((r_attn.AttnConfig, p_attn.AttnConfig), (r_moe.MoEConfig, p_moe.MoEConfig),
                   (r_ssm.MambaConfig, p_ssm.MambaConfig), (r_ssm.RWKV6Config, p_ssm.RWKV6Config),
                   (r_layers.MLPConfig, p_layers.MLPConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(rc)] == \
            [(f.name, f.default) for f in dataclasses.fields(pc)]
