"""The port's training step (repro_torch.train.trainer, autograd through
repro_torch.models) against the reference's, on the CPU.

Each of the ten reduced architectures runs on the reference's parameters
(its seeded init_params, carried across by params_from_numpy): the fp32
loss within 5e-5 relative, and every gradient leaf of autograd within
1e-4 * max|g_ref| + 1e-6 of jax.grad's, leaf by leaf in the reference's
layout (the port's per-layer gradients re-stacked by params_to_numpy).
Then one make_train_step step's parameters and moments against the
reference's step, microbatch accumulation against the full batch at the
reference's own tolerances (rtol 2e-4, atol 2e-5), the remat policies
giving the same gradients, the expert product's gradient dtypes at
bfloat16, and launch.train resuming from its checkpoint bit for bit."""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as r_configs
from repro.models import moe as r_moe
from repro.models import transformer as r_tf
from repro.train import trainer as r_trainer
from repro.train.optimizer import AdamWConfig as RAdamW
from repro_torch import configs as p_configs
from repro_torch.launch import train as p_launch
from repro_torch.models import moe as p_moe
from repro_torch.models.carry import params_from_numpy, params_to_numpy
from repro_torch.models.layers import map_tree
from repro_torch.train import trainer as p_trainer
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import AdamWConfig

ARCHS = sorted(r_configs.ARCHS)
B, S = 2, 8
LOSS_RTOL = 5e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6


def batch(arch: str, cfg, seed: int = 0):
    """(inputs, labels) from `seed`: token ids or stub-frontend embeddings,
    and labels with two positions masked (-100)."""
    rng = np.random.default_rng(seed)
    if r_configs.get_arch(arch).modality == "text":
        x = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    else:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    y = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    y[0, 1] = y[1, 5] = -100
    return x, y


def carried(arch: str, which: str = "reduced", **cut):
    """(reference cfg, port cfg, reference params, port params with
    gradients on)."""
    rcfg = dataclasses.replace(getattr(r_configs.get_arch(arch), which), **cut)
    pcfg = dataclasses.replace(getattr(p_configs.get_arch(arch), which), **cut)
    rp = r_tf.init_params(jax.random.PRNGKey(1), rcfg)
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu").requires_grad_()
    return rcfg, pcfg, rp, pp


def grad_tree(params, grads, cfg):
    """The port's gradients (in parameters() order) in the reference's
    layout, as numpy."""
    it = iter(grads)
    return params_to_numpy(map_tree(lambda _p: next(it), params), cfg)


def port_grads(pp, pcfg, x, y):
    return p_trainer._loss_and_grads(pp, pcfg, torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_grad(arch):
    rcfg, pcfg, rp, pp = carried(arch)
    x, y = batch(arch, rcfg)
    want_loss, want = jax.jit(jax.value_and_grad(r_trainer.loss_fn), static_argnums=1)(
        rp, rcfg, jnp.asarray(x), jnp.asarray(y))
    loss, grads = port_grads(pp, pcfg, x, y)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got = grad_tree(pp, grads, pcfg)
    flat_want, tree_want = jax.tree_util.tree_flatten_with_path(want)
    flat_got, tree_got = jax.tree_util.tree_flatten_with_path(got)
    assert tree_got == tree_want
    for (path, w), (_, g) in zip(flat_want, flat_got):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, jax.tree_util.keystr(path)
        bound = GRAD_REL * np.abs(w).max() + GRAD_ABS
        err = np.abs(g - w).max()
        assert err <= bound, f"{jax.tree_util.keystr(path)}: {err} > {bound}"


def test_train_step_matches_reference_step():
    """One make_train_step step (weight decay on, clipping active) gives
    the reference's metrics, AdamW moments and parameters.

    Each tolerance follows from the gradients' (GRAD_REL * max|g| +
    GRAD_ABS a leaf, from jax.grad's g): m = (1 - b1) g and v = (1 - b2) g^2
    carry it scaled. The first update is g / (|g| + eps), so where |g| is
    within ten times that bound the update is rounding noise in both
    packages, anywhere in [-1, 1]: there the parameters agree within
    2 lr; elsewhere within rtol 1e-4."""
    adamw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, clip_norm=0.5)
    cfg = AdamWConfig(**adamw)
    rcfg, pcfg, rp, pp = carried("qwen2-1.5b")
    r_step = jax.jit(r_trainer.make_train_step(rcfg, r_trainer.TrainConfig(adamw=RAdamW(**adamw))))
    p_step = p_trainer.make_train_step(pcfg, p_trainer.TrainConfig(adamw=cfg))
    from repro.train.optimizer import init_state as r_init
    from repro_torch.train.optimizer import init_state as p_init

    x, y = batch("qwen2-1.5b", rcfg)
    r_grads = jax.tree.leaves(jax.jit(jax.grad(r_trainer.loss_fn), static_argnums=1)(
        rp, rcfg, jnp.asarray(x), jnp.asarray(y)))
    r_opt, p_opt = r_init(RAdamW(**adamw), rp), p_init(cfg, pp)
    rp, r_opt, r_m = r_step(rp, r_opt, {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)})
    pp, p_opt, p_m = p_step(pp, p_opt, {"inputs": torch.from_numpy(x),
                                        "labels": torch.from_numpy(y)})
    for k in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(p_m[k]), float(r_m[k]), rtol=1e-5)
    clip = adamw["clip_norm"] / float(r_m["grad_norm"])
    assert clip < 1
    assert int(p_opt["step"]) == int(r_opt["step"]) == 1
    leaves = [jax.tree.leaves(params_to_numpy(t, pcfg)) for t in (pp, p_opt["m"], p_opt["v"])]
    wants = [jax.tree.leaves(t) for t in (rp, r_opt["m"], r_opt["v"])]
    for i, g in enumerate(r_grads):
        g = np.abs(np.asarray(g)) * clip
        bound = (GRAD_REL * g.max() + GRAD_ABS) * clip
        (p, m, v), (want_p, want_m, want_v) = [[np.asarray(t[i]) for t in ts]
                                               for ts in (leaves, wants)]
        np.testing.assert_allclose(m, want_m, rtol=1e-4, atol=(1 - cfg.b1) * bound)
        np.testing.assert_allclose(v, want_v, rtol=2e-4,
                                   atol=(1 - cfg.b2) * bound * (2 * g.max() + bound))
        signal = g > 10 * bound
        np.testing.assert_allclose(p[signal], want_p[signal], rtol=1e-4, atol=1e-6)
        assert np.abs(p - want_p).max() <= 2 * cfg.lr


def test_microbatch_accumulation_matches_full_batch():
    """The reference's test, on the port: 4 microbatches against 1."""
    cfg = p_configs.get_arch("qwen2-1.5b").reduced
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                              d_ff=64, vocab=64, head_dim=0, qkv_bias=False, remat=False)
    adamw = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    data = synthetic_batch(DataConfig(64, 16, 8), 0)
    out = []
    for mb in (1, 4):
        params, opt = p_trainer.init_train_state(cfg, p_trainer.TrainConfig(adamw=adamw),
                                                 device="cpu")
        step = p_trainer.make_train_step(cfg, p_trainer.TrainConfig(adamw=adamw, microbatches=mb))
        params, _, m = step(params, opt, {k: torch.from_numpy(v) for k, v in data.items()})
        out.append((params, m))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=2e-4)
    for a, b in zip(p1.parameters(), p2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        p_trainer.make_train_step(cfg, p_trainer.TrainConfig(adamw=adamw, microbatches=3))(
            params, opt, {k: torch.from_numpy(v) for k, v in data.items()})


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-1.5-large-398b"])
def test_remat_policies_give_the_same_gradients(arch):
    """remat off, "none" (recompute the unit) and "dots" (keep its 2-D
    products) differ only in what the backward recomputes."""
    x, y = batch(arch, p_configs.get_arch(arch).reduced)
    grads = []
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        _, pcfg, _, pp = carried(arch, remat=remat, remat_policy=policy)
        grads.append(port_grads(pp, pcfg, x, y))
    (l0, g0), *rest = grads
    for loss, g in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(a, b) for a, b in zip(g, g0))


class OpCounter(TorchDispatchMode):
    """Counts the aten ops that reach the kernels (a remat cache hit does
    not)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_2d_products():
    """Under "dots" the backward recomputes no 2-D product (as many mm as
    with remat off, fewer than under "none") but does recompute the
    batched ones (bmm, as under "none")."""
    x, y = batch("qwen2-1.5b", p_configs.get_arch("qwen2-1.5b").reduced)
    mm, bmm = {}, {}
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        _, pcfg, _, pp = carried("qwen2-1.5b", remat=remat, remat_policy=policy)
        with OpCounter() as ops:
            port_grads(pp, pcfg, x, y)
        mm[remat, policy] = ops.counts["aten.mm.default"] + ops.counts["aten.addmm.default"]
        bmm[remat, policy] = ops.counts["aten.bmm.default"]
    assert mm[True, "dots"] == mm[False, "none"] < mm[True, "none"]
    assert bmm[False, "none"] < bmm[True, "dots"] == bmm[True, "none"]


def test_expert_mm_gradient_dtypes_match_reference():
    """At bfloat16: the forward and the activation gradient in bf16, the
    weight gradient accumulated in fp32 and cast to the weight's dtype;
    the values the reference's within bf16 rounding."""
    rng = np.random.default_rng(0)
    for sub, shapes in (("in", ((2, 4, 5, 8), (4, 8, 6), (2, 4, 5, 6))),
                        ("out", ((2, 4, 5, 6), (4, 6, 8), (2, 4, 5, 8)))):
        buf, w, g = (rng.standard_normal(s).astype(np.float32) for s in shapes)
        jb, jw, jg = (jnp.asarray(a, jnp.bfloat16) for a in (buf, w, g))
        want_out, vjp = jax.vjp(lambda b, ww: r_moe._expert_mm(b, ww, sub), jb, jw)
        want_db, want_dw = vjp(jg)
        tb, tw = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (buf, w))
        out = p_moe._ExpertMM.apply(tb, tw, sub)
        out.backward(torch.from_numpy(g).bfloat16())
        for got, want in ((out, want_out), (tb.grad, want_db), (tw.grad, want_dw)):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            np.testing.assert_allclose(got.detach().float().numpy(),
                                       np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)
        # fp32 accumulation of the weight gradient: the fp32 product, rounded once
        eq = "becd,becf->edf" if sub == "in" else "becf,becd->efd"
        exact = torch.einsum(eq, tb.detach().float(), torch.from_numpy(g).bfloat16().float())
        assert torch.equal(tw.grad, exact.bfloat16())


def test_launch_train_resumes_bit_equal(tmp_path, capsys):
    """launch.train on the CPU: a run of 8 steps saving at 4 and 8, then the
    step-8 checkpoint removed and the run started again: it resumes at 4
    and ends on the uninterrupted run's parameters, bit for bit."""
    import shutil

    args = ["--device", "cpu", "--arch", "qwen2-1.5b", "--steps", "8", "--batch", "4",
            "--seq", "16", "--ckpt-every", "4", "--log-every", "4",
            "--ckpt-dir", str(tmp_path)]
    whole = p_launch.main(args)
    shutil.rmtree(tmp_path / "step_00000008")
    capsys.readouterr()
    resumed = p_launch.main(args)
    assert "resumed from step 4" in capsys.readouterr().out
    assert all(torch.equal(a, b) for a, b in zip(whole.parameters(), resumed.parameters()))
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry point runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_launch.main(["--steps", "1"])
