"""The port's training substrate (repro_torch.train, launch.roofline)
against the reference's, on the CPU.

The reference's tests/test_train_serve.py cases replayed on the port
(AdamW's step, the schedule, clipping, xent masking, data determinism,
reshard_plan, straggler eviction and both monitors on one telemetry,
compression's error feedback); then
apply_updates against the reference's on a reduced model's tree with
weight decay on, which pins the decay rule (the reference decays its
stacked (R, d) block leaves, norm scales and biases included), for both
moment dtypes; the data streams bit for bit; corpus selection exactly;
compressed_psum over 4 gloo ranks against the reference's compressed_psum;
checkpoints, restored across the two packages both ways; and model_flops
for every arch and shape."""
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from repro import configs as r_configs
from repro.launch import roofline as r_roofline
from repro.models import transformer as r_tf
from repro.relational.relation import Relation as RRelation
from repro.train import checkpoint as r_ckpt
from repro.train.compression import _quantize as r_quantize
from repro.train.compression import compressed_psum as r_compressed_psum
from repro.train import data as r_data
from repro.train import optimizer as r_opt
from repro.train import straggler as r_straggler
from repro.train import trainer as r_trainer
from repro_torch import configs as p_configs
from repro_torch.launch import roofline as p_roofline
from repro_torch.models.carry import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import ModelConfig
from repro_torch.relational.relation import Relation
from repro_torch.train import AdamWConfig, TrainConfig, checkpoint, make_train_step, xent_loss
from repro_torch.train.compression import _quantize
from repro_torch.train.data import (DataConfig, markov_batch, select_corpus_samples,
                                    synthetic_batch)
from repro_torch.train.optimizer import (apply_updates, clip_by_global_norm, decays, init_state,
                                         schedule)
from repro_torch.train.straggler import StragglerMonitor, StragglerPolicy, reshard_plan
from repro_torch.train.trainer import init_train_state
from torch_dist_ranks import compression_grad, compression_rank_main

ARCHS = sorted(r_configs.ARCHS)


# ---------------------------------------------------------------------------
# the reference's cases, replayed
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_step():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      clip_norm=1e9, warmup_steps=0, total_steps=10, min_lr_frac=1.0)
    # a one-leaf tree: a model of no layers whose embedding table is w
    params = params_from_numpy({"embed": {"table": np.array([[1.0, -2.0]], np.float32)},
                                "final_norm": {}, "blocks": ()},
                               ModelConfig(name="t", num_layers=0, d_model=2, num_heads=1,
                                           num_kv_heads=1, d_ff=2, vocab=1), "cpu")
    state = init_state(cfg, params)
    apply_updates(cfg, params, [torch.tensor([[0.5, 0.5]])], state)
    m = 0.1 * 0.5 / (1 - 0.9)
    v = 0.01 * 0.25 / (1 - 0.99)
    want = 1.0 - 0.1 * m / (np.sqrt(v) + 1e-8)
    np.testing.assert_allclose(params["embed"]["table"][0, 0].item(), want, rtol=1e-5)
    assert int(state["step"]) == 1


def test_schedule_warmup_and_cosine():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    assert float(schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(schedule(cfg, 110)) == pytest.approx(0.1, rel=1e-3)
    for step in (0, 1, 7, 10, 11, 60, 109, 110, 200):
        assert float(schedule(cfg, torch.tensor(step, dtype=torch.int32))) == \
            float(r_opt.schedule(r_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                                                   min_lr_frac=0.1), jnp.int32(step)))


def test_grad_clipping_caps_norm():
    clipped, gn = clip_by_global_norm([torch.full((4,), 10.0)], 1.0)
    assert float(gn) == pytest.approx(20.0)
    assert float(torch.linalg.norm(clipped[0])) == pytest.approx(1.0, rel=1e-5)
    kept, _ = clip_by_global_norm([torch.full((4,), 0.1, dtype=torch.bfloat16)], 1.0)
    assert kept[0].dtype == torch.bfloat16 and torch.equal(kept[0], torch.full((4,), 0.1).bfloat16())


def test_xent_loss_masking():
    loss = xent_loss(torch.zeros((1, 3, 5)), torch.tensor([[1, -100, 2]]))
    assert float(loss) == pytest.approx(np.log(5), rel=1e-5)
    assert float(xent_loss(torch.zeros((1, 2, 5)), torch.tensor([[-100, -100]]))) == 0.0
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    labels[0, :2] = -100
    np.testing.assert_allclose(float(xent_loss(torch.from_numpy(logits), torch.from_numpy(labels))),
                               float(r_trainer.xent_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)


def test_data_stream_deterministic_and_elastic():
    dcfg = DataConfig(vocab=100, seq_len=8, global_batch=8)
    a = synthetic_batch(dcfg, 3, host=0, num_hosts=2)
    b = synthetic_batch(dcfg, 3, host=0, num_hosts=2)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    c = synthetic_batch(dcfg, 3, host=1, num_hosts=2)
    assert not np.array_equal(a["inputs"], c["inputs"])
    plan = reshard_plan(4, 8, 256)
    assert plan == r_straggler.reshard_plan(4, 8, 256)
    assert plan["per_host_batch"] == 32
    with pytest.raises(ValueError):
        reshard_plan(4, 3, 256)


@pytest.mark.parametrize("fn", ["synthetic_batch", "markov_batch"])
def test_batches_bit_equal_to_reference(fn):
    for vocab, seq, batch, seed in ((64, 16, 8, 0), (151936, 32, 4, 3)):
        for step, host, hosts in ((0, 0, 1), (5, 1, 2), (17, 3, 4)):
            got = globals()[fn](DataConfig(vocab, seq, batch, seed), step, host, hosts)
            want = getattr(r_data, fn)(r_data.DataConfig(vocab, seq, batch, seed), step, host,
                                       hosts)
            for k in ("inputs", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_straggler_monitor_evicts_persistent_offender():
    mon = StragglerMonitor(4, StragglerPolicy(slow_factor=1.5, min_flags=3, restart_cost_steps=10))
    evicted = []
    for _ in range(5):
        r = mon.observe(np.array([1.0, 1.0, 1.0, 3.0]))
        evicted += r["evict"]
    assert 3 in evicted
    r = mon.observe(np.array([1.0, 1.0, 1.0, 1.0]))
    assert r["slow"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_matches_reference(seed):
    """One seeded telemetry sequence fed to both monitors: the same slow and
    evict lists at every window, under the default policy and a strict one."""
    rng = np.random.default_rng(seed)
    hosts = 8
    times = rng.uniform(0.9, 1.1, (40, hosts))
    times[5:30, 3] *= 2.0   # a persistent straggler
    times[::4, 6] *= 1.8    # an intermittent one
    times[12:16, 1] *= 1.2  # slow but under the factor
    for kw in ({}, {"slow_factor": 1.3, "min_flags": 2, "restart_cost_steps": 5.0}):
        mon = StragglerMonitor(hosts, StragglerPolicy(**kw))
        ref = r_straggler.StragglerMonitor(hosts, r_straggler.StragglerPolicy(**kw))
        evicted = []
        for t in times:
            got = mon.observe(t.copy())
            assert got == ref.observe(t.copy())
            evicted += got["evict"]
        assert 3 in evicted
        assert [h.flags for h in mon.hosts] == [h.flags for h in ref.hosts]


def test_compression_error_feedback_converges():
    x = np.float32(0.013)
    scale = np.float32(1.0 / 127.0)
    err = np.float32(0.0)
    outs = []
    for _ in range(50):
        q = float(_quantize(torch.tensor(x + err), torch.tensor(scale)))
        deq = q * scale
        err = x + err - deq
        outs.append(deq)
    assert abs(np.mean(outs) - x) < 1e-4
    vals = np.array([-300.0, -1.5, -0.5, 0.5, 1.5, 2.5, 300.0], np.float32)
    np.testing.assert_array_equal(
        _quantize(torch.from_numpy(vals), torch.tensor(1.0)).numpy(),
        np.asarray(r_quantize(jnp.asarray(vals), jnp.float32(1.0))))


def test_train_loss_decreases_markov():
    """The reference's (slow-marked) markov test, on the port's tiny model."""
    cfg = ModelConfig(
        name="t", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64, vocab=64,
        compute_dtype="float32", remat=False)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    params, opt = init_train_state(cfg, tcfg, device="cpu")
    step = make_train_step(cfg, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for i in range(60):
        batch = {k: torch.from_numpy(v) for k, v in markov_batch(dcfg, i).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2


# ---------------------------------------------------------------------------
# apply_updates on a model's tree, against the reference
# ---------------------------------------------------------------------------


def ref_tree(arch: str, seed: int = 1):
    rcfg, pcfg = r_configs.get_arch(arch).reduced, p_configs.get_arch(arch).reduced
    return rcfg, pcfg, jax.tree.map(np.asarray, r_tf.init_params(jax.random.PRNGKey(seed), rcfg))


def test_decay_rule_is_the_stacked_rank():
    """A block leaf of shape (d,) is (R, d) in the reference: decayed; a
    (d,) leaf outside the blocks is not."""
    d = torch.zeros(8)
    assert decays("blocks.0.ln1.scale", d) and decays("blocks.3.mixer.bq", torch.zeros(2, 4))
    assert not decays("final_norm.scale", d) and decays("embed.table", torch.zeros(4, 8))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(moments):
    """qwen2's reduced tree (QKV biases, norm scales) with weight decay 0.1
    and clipping active, the same random gradients on both sides. Two
    steps with fp32 moments; one with bf16 moments (the second would read
    moments rounded to bf16, where a last-bit difference of the fp32
    values, from the global norm's summation order, can round apart)."""
    _, pcfg, rp = ref_tree("qwen2-1.5b")
    kw = dict(lr=0.1, weight_decay=0.1, clip_norm=0.5, warmup_steps=1, total_steps=10,
              moment_dtype=moments)
    rcfg_opt, pcfg_opt = r_opt.AdamWConfig(**kw), AdamWConfig(**kw)
    pp = params_from_numpy(rp, pcfg, "cpu")
    r_params = jax.tree.map(jnp.asarray, rp)
    r_state, p_state = r_opt.init_state(rcfg_opt, r_params), init_state(pcfg_opt, pp)
    rng = np.random.default_rng(7)
    for step in range(2 if moments == "float32" else 1):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), rp)
        r_params, r_state, r_met = r_opt.apply_updates(rcfg_opt, r_params,
                                                       jax.tree.map(jnp.asarray, g), r_state)
        _, p_state, p_met = apply_updates(pcfg_opt, pp,
                                          list(params_from_numpy(g, pcfg, "cpu").parameters()),
                                          p_state)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(p_met[k]), float(r_met[k]), rtol=1e-6)
    assert int(p_state["step"]) == int(r_state["step"])
    tol = dict(rtol=1e-5, atol=1e-7) if moments == "float32" else dict(rtol=8e-3, atol=1e-7)
    for got, want, t in ((pp, r_params, dict(rtol=1e-5, atol=1e-6)),
                         (p_state["m"], r_state["m"], tol), (p_state["v"], r_state["v"], tol)):
        got = params_to_numpy(got, pcfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            gl = got
            for k in path:
                gl = gl[getattr(k, "key", getattr(k, "idx", None))]
            np.testing.assert_allclose(gl, np.asarray(w, np.float32), **t,
                                       err_msg=jax.tree_util.keystr(path))
    # the moments are held in the moment dtype
    assert {p.dtype for p in p_state["m"].parameters()} == {getattr(torch, moments)}


# ---------------------------------------------------------------------------
# corpus selection, compression
# ---------------------------------------------------------------------------


def corpus(n: int, seed: int = 0):
    """Docs/Quality/Dedup as examples/analytics_pipeline.py makes them."""
    rng = np.random.default_rng(seed)
    cols = {"Docs": {"doc": np.arange(n, dtype=np.int64), "shard": rng.integers(0, 64, n),
                     "lang": rng.integers(0, 30, n)},
            "Quality": {"doc": np.arange(n, dtype=np.int64), "score": rng.integers(0, 100, n)}}
    canonical = np.arange(n, dtype=np.int64)
    dup = rng.random(n) < 0.2
    canonical[dup] = rng.integers(0, n, int(dup.sum()))
    cols["Dedup"] = {"doc": np.arange(n, dtype=np.int64), "canonical": canonical}
    return cols


@pytest.mark.parametrize("n,min_quality", [(1000, 50), (20_000, 60)])
def test_select_corpus_samples_matches_reference(n, min_quality):
    cols = corpus(n)
    got = select_corpus_samples(*(Relation(k, v) for k, v in cols.items()), min_quality,
                                device="cpu")
    want = r_data.select_corpus_samples(*(RRelation(k, v) for k, v in cols.items()), min_quality)
    np.testing.assert_array_equal(got, want)
    oracle = np.flatnonzero((cols["Quality"]["score"] >= min_quality) &
                            (cols["Dedup"]["canonical"] == cols["Dedup"]["doc"]))
    np.testing.assert_array_equal(got, oracle)
    assert select_corpus_samples.__defaults__[-1] == "cuda"


def reference_compression(world: int, steps: int = 2):
    """The reference's compressed_psum on the same gradient, one row per
    member of a vmapped "data" axis (its psum and pmax reduce over that
    axis as over a mesh axis): per step, every row's (out, err). Run op by
    op, not jitted: jitted, XLA's CPU fusion of x - q * scale moves the
    error state by up to 1.6e-7 (one fp32 rounding of q * scale) from the
    separate product and difference that the reference's code writes;
    the outputs agree either way."""
    fn = jax.vmap(lambda g, e: r_compressed_psum(g, e, "data"), axis_name="data")
    g = {"w": jnp.asarray(compression_grad(world))}
    err = {"w": jnp.zeros((world, 8), jnp.float32)}
    res = []
    for _ in range(steps):
        out, err = fn(g, err)
        res.append((np.asarray(out["w"]), np.asarray(err["w"])))
    return res


def test_compressed_psum_across_gloo_ranks(tmp_path):
    """4 gloo ranks, one row of the reference's COMPRESSION_SCRIPT gradient
    each: every rank's mean is within 0.02 of the exact mean (the script's
    check), and every rank's output and error state equal the reference's
    compressed_psum on the same rows, over two steps (the second carries
    the first's error)."""
    world = 4
    ctx = tmp.get_context("spawn")
    outs = [str(tmp_path / f"rank_{r}.json") for r in range(world)]
    procs = [ctx.Process(target=compression_rank_main,
                         args=(r, world, str(tmp_path / "store"), outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(120)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    got = []
    for path in outs:
        with open(path) as f:
            got.append(json.load(f))
    exact = np.tile(compression_grad(world).mean(0), (world, 1))
    for step, (want_out, want_err) in enumerate(reference_compression(world)):
        out = np.array([got[r][step]["out"][0] for r in range(world)], np.float32)
        err = np.array([got[r][step]["err"][0] for r in range(world)], np.float32)
        assert np.abs(out - exact).max() < 0.02
        np.testing.assert_array_equal(out, want_out)
        np.testing.assert_array_equal(err, want_err)


# ---------------------------------------------------------------------------
# checkpoints and the carried layout
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_latest():
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16), "n": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        assert checkpoint.latest_step(d) is None
        checkpoint.save(d, 5, tree)
        checkpoint.save(d, 10, tree)
        assert checkpoint.latest_step(d) == 10
        like = {k: torch.zeros_like(v) for k, v in tree.items()}
        restored = checkpoint.restore(d, 10, like)
        for k, v in tree.items():
            assert restored[k].dtype == v.dtype and torch.equal(restored[k], v)
        with open(f"{d}/step_00000010/manifest.json") as f:
            manifest = json.load(f)
    assert manifest["leaves"]["['b']"] == {"shape": [3], "dtype": "bfloat16"}
    assert manifest["leaves"]["['n']"] == {"shape": [], "dtype": "int32"}


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"w": torch.zeros((2, 2)), "v": torch.zeros(3)})
        like = {"w": torch.ones((3, 3)), "v": torch.ones(3)}
        with pytest.raises(ValueError, match="shape"):
            checkpoint.restore(d, 1, like)
        assert torch.equal(like["v"], torch.ones(3)), "a rejected restore wrote a leaf"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """reference -> port -> reference, bit for bit, in the reference's
    tree structure; bf16 leaves come back as their fp32 values."""
    _, pcfg, rp = ref_tree(arch)
    back = params_to_numpy(params_from_numpy(rp, pcfg, "cpu"), pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(rp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if arch == "mixtral-8x22b":
        rb = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), rp)
        pb = params_from_numpy(rb, pcfg, "cpu")
        assert {p.dtype for p in pb.parameters()} == {torch.bfloat16}
        for a, b in zip(jax.tree.leaves(params_to_numpy(pb, pcfg)), jax.tree.leaves(rb)):
            assert np.array_equal(a, np.asarray(b, np.float32))


def train_states(moments: str):
    """(reference cfg, port cfg, TrainConfig kwargs) on jamba's reduced
    config (two pattern positions, stacked R = 1) with weight decay."""
    rcfg, pcfg = (c.get_arch("jamba-1.5-large-398b").reduced for c in (r_configs, p_configs))
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, moment_dtype=moments)
    return rcfg, pcfg, kw


def one_step(cfg, params, opt, step_fn, to):
    x = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return step_fn(params, opt, {"inputs": to(x), "labels": to(np.roll(x, -1, 1))})


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, moments):
    rcfg, pcfg, kw = train_states(moments)
    rt = r_trainer.TrainConfig(adamw=r_opt.AdamWConfig(**kw))
    rp, ropt = r_trainer.init_train_state(jax.random.PRNGKey(0), rcfg, rt)
    rp, ropt, _ = one_step(rcfg, rp, ropt, jax.jit(r_trainer.make_train_step(rcfg, rt)),
                           jnp.asarray)
    r_ckpt.save(str(tmp_path), 1, {"params": rp, "opt": ropt})
    pp, popt = init_train_state(pcfg, TrainConfig(adamw=AdamWConfig(**kw)), device="cpu")
    checkpoint.restore(str(tmp_path), 1, {"params": pp, "opt": popt}, pcfg)
    assert int(popt["step"]) == 1 and popt["step"].dtype == torch.int32
    for got, want in ((pp, rp), (popt["m"], ropt["m"]), (popt["v"], ropt["v"])):
        got = params_to_numpy(got, pcfg)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(tmp_path, moments):
    rcfg, pcfg, kw = train_states(moments)
    tcfg = TrainConfig(adamw=AdamWConfig(**kw))
    pp, popt = init_train_state(pcfg, tcfg, device="cpu")
    pp, popt, _ = one_step(pcfg, pp, popt, make_train_step(pcfg, tcfg), torch.from_numpy)
    checkpoint.save(str(tmp_path), 1, {"params": pp, "opt": popt}, pcfg)
    rt = r_trainer.TrainConfig(adamw=r_opt.AdamWConfig(**kw))
    like = jax.eval_shape(lambda: r_trainer.init_train_state(jax.random.PRNGKey(0), rcfg, rt))
    restored = r_ckpt.restore(str(tmp_path), 1, {"params": like[0], "opt": like[1]})
    assert int(restored["opt"]["step"]) == 1
    for got, want in ((restored["params"], pp), (restored["opt"]["m"], popt["m"]),
                      (restored["opt"]["v"], popt["v"])):
        assert jax.tree.structure(got) == jax.tree.structure(params_to_numpy(want, pcfg))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params_to_numpy(want, pcfg))):
            assert np.array_equal(np.asarray(a, np.float32), b)


def test_model_state_roundtrip_in_port(tmp_path):
    """A train state saved and restored into a fresh one: every leaf equal,
    bit for bit; a state of another config is rejected."""
    _, pcfg, kw = train_states("float32")
    tcfg = TrainConfig(adamw=AdamWConfig(**kw))
    pp, popt = init_train_state(pcfg, tcfg, seed=3, device="cpu")
    pp, popt, _ = one_step(pcfg, pp, popt, make_train_step(pcfg, tcfg), torch.from_numpy)
    checkpoint.save(str(tmp_path), 1, {"params": pp, "opt": popt}, pcfg)
    fresh = init_train_state(pcfg, tcfg, seed=4, device="cpu")
    checkpoint.restore(str(tmp_path), 1, {"params": fresh[0], "opt": fresh[1]}, pcfg)
    for a, b in zip([*pp.parameters(), *popt["m"].parameters(), *popt["v"].parameters()],
                    [*fresh[0].parameters(), *fresh[1]["m"].parameters(),
                     *fresh[1]["v"].parameters()]):
        assert torch.equal(a, b)
    other = p_configs.get_arch("qwen2-1.5b").reduced
    op, oo = init_train_state(other, tcfg, device="cpu")
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path), 1, {"params": op, "opt": oo}, other)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_model_flops_match_reference():
    for arch in ARCHS:
        for shape in r_configs.SHAPES:
            assert p_roofline.model_flops(arch, shape) == r_roofline.model_flops(arch, shape)
    assert p_roofline.model_flops("qwen2-1.5b", "train_4k") == 6 * 1_543_714_304 * 4096 * 256
    assert (p_roofline.PEAK_FLOPS, p_roofline.HBM_BW) == (989e12, 3.35e12)
