"""The port's LM (repro_torch.models.transformer) and its config registry
against the reference's, on the CPU.

Each of the ten reduced architectures runs on the reference's parameters
(its seeded init_params, carried across as numpy by params_from_numpy):
apply_model's logits within atol 5e-4, the reference's own decode test
tolerance; for the four archs of the reference's decode test, every
decode_step's logits and every cache leaf, and the port's decode against
its own prefill. The registry compares field for field."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tf
from repro_torch import configs as p_configs
from repro_torch.models import transformer as p_tf
from repro_torch.models.carry import cache_from_numpy, params_from_numpy

ARCHS = sorted(r_configs.ARCHS)
DECODE_ARCHS = ["qwen2-1.5b", "mixtral-8x22b", "jamba-1.5-large-398b", "rwkv6-1.6b"]
TOL = dict(rtol=5e-4, atol=5e-4)
B, S = 2, 8


def reduced(configs, arch: str):
    """The arch's reduced config as the reference's decode test runs it:
    MoE capacity high enough that prefill and decode drop nothing."""
    cfg = dataclasses.replace(configs.get_arch(arch).reduced, remat=False)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.fixture(scope="module")
def arch_case():
    """arch -> (reference cfg, port cfg, reference params, port params,
    inputs), built once per arch for the module."""
    cases = {}

    def get(arch):
        if arch not in cases:
            rcfg, pcfg = reduced(r_configs, arch), reduced(p_configs, arch)
            rp = r_tf.init_params(jax.random.PRNGKey(1), rcfg)
            pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
            rng = np.random.default_rng(0)
            if r_configs.get_arch(arch).modality == "text":
                x = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
            else:
                x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
            cases[arch] = (rcfg, pcfg, rp, pp, x)
        return cases[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_model_matches_reference(arch, arch_case):
    rcfg, pcfg, rp, pp, x = arch_case(arch)
    want = jax.jit(lambda p, x: r_tf.apply_model(p, rcfg, x))(rp, jnp.asarray(x))
    got = p_tf.apply_model(pp, pcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, S, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last = p_tf.apply_model(pp, pcfg, torch.from_numpy(x), last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference_and_prefill(arch, arch_case):
    rcfg, pcfg, rp, pp, x = arch_case(arch)
    step = jax.jit(lambda p, t, c, cur: r_tf.decode_step(p, rcfg, t, c, cur))
    r_cache = r_tf.init_cache(rcfg, B, S)
    p_cache = p_tf.init_cache(pcfg, B, S, device="cpu")
    assert [tuple(leaf.shape) for pos in p_cache for leaf in pos] == \
        [leaf.shape for leaf in jax.tree.leaves(r_cache)]
    outs = []
    for t in range(S):
        want, r_cache = step(rp, jnp.asarray(x[:, t:t + 1]), r_cache, jnp.int32(t))
        got, p_cache = p_tf.decode_step(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), p_cache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for r_leaf, p_leaf in zip(jax.tree.leaves(r_cache), [l for pos in p_cache for l in pos]):
            assert p_leaf.dtype == getattr(torch, str(r_leaf.dtype))
            np.testing.assert_allclose(p_leaf.numpy(), np.asarray(r_leaf), **TOL)
        outs.append(got)
    full = p_tf.apply_model(pp, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)


def test_carried_cache_continues_decode(arch_case):
    """A reference cache carried across mid-sequence: the port's next
    decode steps continue it as the reference's do."""
    rcfg, pcfg, rp, pp, x = arch_case("rwkv6-1.6b")
    step = jax.jit(lambda p, t, c, cur: r_tf.decode_step(p, rcfg, t, c, cur))
    r_cache = r_tf.init_cache(rcfg, B, S)
    for t in range(4):
        _, r_cache = step(rp, jnp.asarray(x[:, t:t + 1]), r_cache, jnp.int32(t))
    p_cache = cache_from_numpy(jax.tree.map(np.asarray, r_cache), "cpu")
    for t in range(4, S):
        want, r_cache = step(rp, jnp.asarray(x[:, t:t + 1]), r_cache, jnp.int32(t))
        got, p_cache = p_tf.decode_step(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), p_cache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_parameter_tree_layout(arch_case):
    """Parameter names and shapes are the reference's paths, with block
    leaves unstacked: layer r * len(pattern) + pos holds leaf [r]."""
    rcfg, pcfg, rp, pp, _ = arch_case("jamba-1.5-large-398b")
    unit = len(pcfg.block_pattern)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(rp):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "blocks":
            for r in range(leaf.shape[0]):
                name = ".".join(["blocks", str(r * unit + keys[1]), *map(str, keys[2:])])
                want[name] = tuple(leaf.shape[1:])
        else:
            want[".".join(map(str, keys))] = tuple(leaf.shape)
    assert {k: tuple(v.shape) for k, v in pp.named_parameters()} == want
    assert sum(v.numel() for v in pp.parameters()) == \
        sum(leaf.size for leaf in jax.tree.leaves(rp))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b", "jamba-1.5-large-398b",
                                  "rwkv6-1.6b", "arctic-480b"])
def test_cast_once_is_bit_equal(arch, arch_case):
    """compute_params (the decode engine's one cast) gives the same bits as
    casting every weight on every call, at a bfloat16 compute dtype, and
    leaves the fp32 reads (norms, router, A_log, D, w0, u) in fp32."""
    _, pcfg, _, pp, x = arch_case(arch)
    cfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
    cast = p_tf.compute_params(pp, cfg)
    want, c1 = p_tf.decode_step(pp, cfg, torch.from_numpy(x[:, :1]),
                                p_tf.init_cache(cfg, B, S, device="cpu"), 0)
    got, c2 = p_tf.decode_step(cast, cfg, torch.from_numpy(x[:, :1]),
                               p_tf.init_cache(cfg, B, S, device="cpu"), 0)
    assert torch.equal(got, want)
    for a, b in zip([l for pos in c1 for l in pos], [l for pos in c2 for l in pos]):
        assert torch.equal(a, b)
    assert torch.equal(p_tf.apply_model(cast, cfg, torch.from_numpy(x)),
                       p_tf.apply_model(pp, cfg, torch.from_numpy(x)))
    kept = {"scale", "bias", "router", "A_log", "D", "w0", "u", "table", "out"}
    for name, leaf in cast.named_parameters():
        want_dtype = torch.float32 if name.split(".")[-1] in kept else torch.bfloat16
        assert leaf.dtype == want_dtype, name


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_matches_reference(arch):
    r_spec, p_spec = r_configs.get_arch(arch), p_configs.get_arch(arch)
    for which in ("model", "reduced"):
        r_cfg, p_cfg = getattr(r_spec, which), getattr(p_spec, which)
        assert dataclasses.asdict(p_cfg) == dataclasses.asdict(r_cfg)
        assert p_cfg.hd == r_cfg.hd and p_cfg.repeats == r_cfg.repeats
        assert [p_cfg.is_moe_layer(i) for i in range(len(p_cfg.block_pattern))] == \
            [r_cfg.is_moe_layer(i) for i in range(len(r_cfg.block_pattern))]
        assert str(p_cfg.pdtype()).removeprefix("torch.") == str(r_cfg.pdtype())
        assert str(p_cfg.cdtype()).removeprefix("torch.") == str(r_cfg.cdtype())
    for field in ("opt_dtype", "modality", "long_context_ok", "notes"):
        assert getattr(p_spec, field) == getattr(r_spec, field)
    for shape in (*r_configs.SHAPES, "no_such_shape"):
        assert p_spec.shape_supported(shape) == r_spec.shape_supported(shape)
    for shape in r_configs.SHAPES:
        r_in, p_in = r_spec.input_specs(shape), p_spec.input_specs(shape)
        assert sorted(p_in) == sorted(r_in)
        for k, spec in r_in.items():
            assert p_in[k].device.type == "meta"
            assert tuple(p_in[k].shape) == tuple(spec.shape)
            assert str(p_in[k].dtype).removeprefix("torch.") == str(spec.dtype)


def test_registry_lists_the_same_archs():
    assert sorted(p_configs.ARCHS) == sorted(r_configs.ARCHS)
    assert p_configs.SHAPES == r_configs.SHAPES
    with pytest.raises(KeyError, match="unknown arch"):
        p_configs.get_arch("no-such-arch")


def test_model_config_fields_match():
    assert [(f.name, f.default) for f in dataclasses.fields(p_tf.ModelConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(r_tf.ModelConfig)]


def test_entry_points_want_the_card():
    """Without device="cpu", the entry points ask for the card, and raise
    where there is none instead of running on the CPU."""
    cfg = reduced(p_configs, "qwen2-1.5b")
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_tf.init_cache(cfg, 2, 8)
    params = p_tf.init_params(cfg, seed=3, device="cpu")
    assert next(params.parameters()).device.type == "cpu"
    again = p_tf.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
