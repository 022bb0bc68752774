"""The LM over DTensors with a "model" axis wider than one
(repro_torch.models.tp), against the plain tensors' path, on 4 gloo ranks.

Every reduced config of tests/torch_dist_ranks.py:TP_CASES runs, in fp32,
on a (1, 4) and a (2, 2) ("data", "model") mesh placed as the dry-run
places it (param_spec, batch_spec, cache_spec, the activation
constraints): heads split with kv groups sliced (qwen2 at 4) and split
(at 2), expert-parallel MoE (mixtral, arctic, jamba) and the split over
the expert hidden dim (mixtral-e6 at 4), a dense residual branch
(arctic), rwkv6 and mamba split over heads and d_inner, the
vocab-parallel embedding, unembedding and loss. The loss, every
parameter gradient, and one decode step's logits and cache, gathered
whole, equal the plain path's within fp32 rounding of the sums' order.
"""
import functools

import pytest
import torch
import torch.multiprocessing as tmp

from repro_torch.models import tp
from tests.torch_dist_ranks import (TP_CASES, TP_MESHES, tp_config, tp_plain,
                                    tp_rank_main)

SEED, BATCH, WORLD = 5, 2, 4
CASES = [c[0] for c in TP_CASES]
MESHES = {f"{a}x{b}": (a, b) for a, b in TP_MESHES}
# relative to the largest magnitude of the compared tensor: the sharded
# path sums the same products in another order (partial sums over the
# model ranks, then an all-reduce). rwkv6's bonus `u` sums its gradient
# over the whole recurrence: in fp32 the plain path's own is 1.07e-5 from
# a float64 evaluation of the same model, so its bound is 4e-5.
TOL = 1e-5
LEAF_TOL = {"mixer.u": 4e-5}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's gathered results of every case on both meshes."""
    tmp_path = tmp_path_factory.mktemp("tp")
    ctx = tmp.get_context("spawn")
    out = str(tmp_path / "rank0.pt")
    procs = [ctx.Process(target=tp_rank_main,
                         args=(r, WORLD, str(tmp_path / "store"), out, BATCH, SEED))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(300)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * WORLD
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return torch.load(out)


@functools.cache
def plain(case: str) -> dict:
    _, arch, experts = next(c for c in TP_CASES if c[0] == case)
    return tp_plain(tp_config(arch, experts), BATCH, SEED)


def close(got: torch.Tensor, want: torch.Tensor, what: str, tol: float = TOL):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got.double() - want.double()).abs().max()) if want.numel() else 0.0
    assert err <= tol * max(scale, 1e-6), f"{what}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_tp_loss_and_gradients_match_plain(sharded, case, mesh):
    got, want = sharded[(case, MESHES[mesh])], plain(case)
    close(got["loss"], want["loss"], "loss")
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        tol = next((t for k, t in LEAF_TOL.items() if name.endswith(k)), TOL)
        close(got["grads"][name], g, name, tol)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_tp_decode_step_matches_plain(sharded, case, mesh):
    got, want = sharded[(case, MESHES[mesh])], plain(case)
    close(got["logits"], want["logits"], "logits")
    for i, (gpos, wpos) in enumerate(zip(got["cache"], want["cache"], strict=True)):
        for j, (g, w) in enumerate(zip(gpos, wpos, strict=True)):
            close(g, w, f"cache[{i}][{j}]")


def test_tp_cases_take_the_split_paths():
    """The cases above reach each layout: heads split with kv groups sliced
    or split, experts split or their hidden dim, rwkv6 heads, vocab."""
    qwen2 = tp_config("qwen2-1.5b", None).attn_cfg
    assert tp._heads_split(qwen2, 4) == (True, False)  # a kv group across 2 ranks
    assert tp._heads_split(qwen2, 2) == (True, True)
    for experts, n, by_expert in ((None, 4, True), (6, 4, False), (6, 2, True)):
        moe = tp_config("mixtral-8x22b", experts).moe
        assert (moe.num_experts % n == 0) == by_expert
        assert by_expert or moe.d_ff % n == 0
    rwkv = tp_config("rwkv6-1.6b", None)
    assert rwkv.num_heads % 4 == 0 and rwkv.vocab % 4 == 0
    jamba = tp_config("jamba-1.5-large-398b", None)
    assert jamba.mamba_cfg.d_inner % 4 == 0
