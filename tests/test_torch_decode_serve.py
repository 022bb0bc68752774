"""The port's decode serving (repro_torch.serve.DecodeServeEngine, its paged
KV allocator, and python -m repro_torch.launch.serve) against the
reference's, on the CPU.

Both engines serve the same requests on the same parameters (the
reference's seeded init_params, carried across by params_from_numpy):
every request's tokens, the engine's step count and done flags, and the
allocator's owner map and free list must be equal. Each emitted token's
top-2 logit gap exceeds 1e-3, so exact token equality is sound.

The reference engine is driven with each decode step awaited before the
host writes the next step's inputs (SyncedEngine): on the CPU backend
`jnp.asarray` of the engine's host arrays can alias them, and an
unawaited step can then read the token the host writes after dispatch,
which makes the reference's tokens vary from run to run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.models import transformer as r_tf
from repro.serve import DecodeServeEngine as RefEngine
from repro.serve import PagedAllocator as RefAllocator
from repro.serve import Request as RefRequest
from repro_torch import configs as p_configs
from repro_torch.launch import serve as p_serve
from repro_torch.models import transformer as p_tf
from repro_torch.models.carry import params_from_numpy
from repro_torch.serve import DecodeServeEngine, PagedAllocator, Request, ServeEngine

GAP = 1e-3


class SyncedEngine(RefEngine):
    """The reference engine, each decode awaited before it returns."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        decode = self._decode
        self._decode = lambda *a: jax.block_until_ready(decode(*a))


# test_train_serve.py's model
SERVE_KW = dict(name="t", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                vocab=64, compute_dtype="float32", remat=False)


def arch_configs(arch: str):
    r_cfg, p_cfg = r_configs.get_arch(arch).reduced, p_configs.get_arch(arch).reduced
    if r_cfg.moe is not None:
        r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(r_cfg.moe, capacity_factor=8.0))
        p_cfg = dataclasses.replace(p_cfg, moe=dataclasses.replace(p_cfg.moe, capacity_factor=8.0))
    return r_cfg, p_cfg


def serve_case():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, 3).astype(np.int32) for _ in range(5)]
    return (r_tf.ModelConfig(**SERVE_KW), p_tf.ModelConfig(**SERVE_KW), 3, 32, 0, prompts,
            [4] * 5)


def mixed_case(arch: str, seed: int):
    """Six requests of mixed prompt lengths and budgets over 3 slots with
    max_len 24: two of them run into max_len before max_new."""
    r_cfg, p_cfg = arch_configs(arch)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, r_cfg.vocab, n).astype(np.int32) for n in (3, 9, 1, 14, 5, 7)]
    return r_cfg, p_cfg, 3, 24, seed, prompts, [6, 20, 3, 12, 30, 4]


# the seeds: ones at which every emitted token's top-2 gap clears GAP (with
# 128-token vocabularies near-ties are common: mixtral's seed 1 has one at
# 2.2e-4, where the tokens agree but exact equality would rest on rounding)
CASES = {
    "train_serve": serve_case,
    "mixtral": lambda: mixed_case("mixtral-8x22b", 5),
    "rwkv6": lambda: mixed_case("rwkv6-1.6b", 1),
}


def serve(engine_cls, request_cls, params, cfg, slots, max_len, prompts, max_new, **kw):
    eng = engine_cls(params, cfg, slots=slots, max_len=max_len, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference(case):
    r_cfg, p_cfg, slots, max_len, seed, prompts, max_new = CASES[case]()
    r_params = r_tf.init_params(jax.random.PRNGKey(seed), r_cfg)
    p_params = params_from_numpy(jax.tree.map(np.asarray, r_params), p_cfg, "cpu")
    gaps = []

    def on_emit(req, pos, logits):
        top2 = torch.topk(logits, 2).values
        gaps.append(float(top2[0] - top2[1]))
        assert int(torch.argmax(logits)) == req.out[-1]

    r_eng, r_reqs = serve(SyncedEngine, RefRequest, r_params, r_cfg, slots, max_len, prompts,
                          max_new)
    p_eng, p_reqs = serve(DecodeServeEngine, Request, p_params, p_cfg, slots, max_len, prompts,
                          max_new, on_emit=on_emit)
    assert [r.out for r in p_reqs] == [r.out for r in r_reqs]
    assert [r.done for r in p_reqs] == [r.done for r in r_reqs] == [True] * len(prompts)
    assert p_eng.steps == r_eng.steps
    assert p_eng.pages.owner == r_eng.pages.owner
    assert p_eng.pages.free == r_eng.pages.free
    np.testing.assert_array_equal(p_eng.cur_len, r_eng.cur_len)
    assert len(gaps) == sum(len(r.out) for r in p_reqs)
    assert min(gaps) > GAP
    if case != "train_serve":  # the case's premise: some requests stop at max_len
        assert any(len(r.out) < m for r, m in zip(p_reqs, max_new))


def test_engine_runs_where_its_parameters_are():
    """The engine runs where its parameters are; ServeEngine is the same
    class under the reference's older name."""
    assert ServeEngine is DecodeServeEngine
    cfg = p_tf.ModelConfig(**SERVE_KW)
    eng = DecodeServeEngine(p_tf.init_params(cfg, device="cpu"), cfg, slots=2, max_len=16)
    assert eng.device.type == "cpu"
    assert all(leaf.device.type == "cpu" for pos in eng.cache for leaf in pos)


# ---------------------------------------------------------------------------
# the paged allocator
# ---------------------------------------------------------------------------


def allocator_script(pa, big: int):
    """One sequence of alloc / release / lookup / page_index; returns what
    each call gave."""
    out = [pa.alloc(1, 20), pa.alloc(2, 8), pa.alloc(big, 33), pa.alloc(1, 24)]
    out.append(pa.lookup(np.array([1, 1, 1, 2, big, big, 9]), np.array([0, 1, 2, 0, 2, 3, 0])))
    out.append(pa.page_index([1, big, 7], 4))
    pa.release(1)
    out.append(pa.lookup(np.array([1, 2, big]), np.array([0, 0, 1])))
    out.append(pa.alloc(3, 16 * 4))
    with pytest.raises(MemoryError, match="exhausted"):
        pa.alloc(4, 16 * 8 + 1)
    out.append(pa.lookup(np.array([3, 3, 4]), np.array([0, 3, 0])))
    pa.release(big)
    pa.release(99)
    out.append(pa.alloc(5, 1))
    out.append(pa.page_index([2, 3, 5], 5))
    out.append((pa.owner, pa.free))
    return out


@pytest.mark.parametrize("big", [7, 2**31 + 5, 2**40 + 3])
def test_paged_allocator_matches_reference(big):
    got = allocator_script(PagedAllocator(num_pages=10, page_size=16), big)
    want = allocator_script(RefAllocator(num_pages=10, page_size=16), big)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_paged_allocator_large_seq_ids():
    """seq_ids of 2**31 and more, which an int32 table would refuse."""
    pa = PagedAllocator(num_pages=64, page_size=8)
    ids = [2**31, 2**31 + 1, 2**62, 3]
    for i, sid in enumerate(ids):
        pa.alloc(sid, 8 * (i + 1))
    seqs = np.repeat(ids, [1, 2, 3, 4])
    pages = np.concatenate([np.arange(n) for n in (1, 2, 3, 4)])
    slots = pa.lookup(seqs, pages)
    assert (slots >= 0).all() and len(set(slots.tolist())) == len(slots)
    np.testing.assert_array_equal(slots, [pa.owner[s][p] for s, p in zip(seqs, pages)])
    assert (pa.lookup(np.array([2**31 + 2, 2**62]), np.array([0, 3])) == -1).all()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launch_serve_on_cpu(capsys):
    eng = p_serve.main(["--device", "cpu", "--arch", "qwen2-1.5b", "--requests", "3",
                        "--slots", "2", "--max-new", "3", "--max-len", "32"])
    assert "served 3 requests (9 tokens)" in capsys.readouterr().out
    assert eng.steps > 0 and not eng.queue and not any(eng.active)


def test_launch_serve_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the launcher runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.main(["--arch", "qwen2-1.5b", "--requests", "1"])
