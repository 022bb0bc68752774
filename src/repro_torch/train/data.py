"""Data pipeline: deterministic, resumable token streams + relational
sample selection through the Free Join engine (the paper's technique
applied at the framework layer).

Determinism & fault tolerance: batch(step, host) is a pure function of
(seed, step, host), so resume-after-failure = restore checkpoint + continue
at step+1 — no stream state to persist, no data replay drift. Elastic
rescale changes `num_hosts` and the per-host slice, not the global stream.
The streams are numpy, bit for bit the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import free_join
from repro_torch.core.engine import materialize
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def synthetic_batch(cfg: DataConfig, step: int, host: int = 0, num_hosts: int = 1):
    """Per-host slice of the global batch for `step` (pure function)."""
    assert cfg.global_batch % num_hosts == 0
    per_host = cfg.global_batch // num_hosts
    rng = np.random.default_rng((cfg.seed, step, host))
    tokens = rng.integers(0, cfg.vocab, (per_host, cfg.seq_len + 1), dtype=np.int32)
    return {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}


def _bigram_table(vocab: int, seed: int) -> np.ndarray:
    """A fixed sparse-ish bigram distribution: each token has 4 likely
    successors. Gives the LM a learnable signal."""
    rng = np.random.default_rng(seed + 12345)
    return rng.integers(0, vocab, (vocab, 4))


def markov_batch(cfg: DataConfig, step: int, host: int = 0, num_hosts: int = 1):
    """Learnable synthetic stream: tokens follow a fixed bigram chain with
    90% probability (10% noise). Same determinism contract as
    synthetic_batch."""
    assert cfg.global_batch % num_hosts == 0
    per_host = cfg.global_batch // num_hosts
    succ = _bigram_table(cfg.vocab, cfg.seed)
    rng = np.random.default_rng((cfg.seed, step, host))
    toks = np.empty((per_host, cfg.seq_len + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, cfg.vocab, per_host)
    choice = rng.integers(0, 4, (per_host, cfg.seq_len))
    noise = rng.random((per_host, cfg.seq_len)) < 0.1
    noise_tok = rng.integers(0, cfg.vocab, (per_host, cfg.seq_len), dtype=np.int32)
    for t in range(cfg.seq_len):
        nxt = succ[toks[:, t], choice[:, t]]
        toks[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
    return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}


def select_corpus_samples(
    docs: Relation,
    quality: Relation,
    dedup: Relation,
    min_quality: int,
    device="cuda",
) -> np.ndarray:
    """Relational sample selection: which documents enter training?

        Keep(doc, shard) :- Docs(doc, shard, lang),
                            Quality(doc, score >= min_quality),
                            Dedup(doc, canonical == doc)

    Runs as the eager Free Join on `device` (plan converted+factored from
    the cost-based binary plan; the card unless the CPU is asked for).
    Returns the selected doc ids, sorted. It is the paper's engine doing
    framework work.
    """
    q = Query(
        [
            Atom("Docs", ("doc", "shard", "lang")),
            Atom("Quality", ("doc", "score")),
            Atom("Dedup", ("doc", "canonical")),
        ]
    )
    qual = quality.select(np.asarray(quality.columns["score"]) >= min_quality)
    ded = dedup.select(np.asarray(dedup.columns["canonical"]) == np.asarray(dedup.columns["doc"]))
    bound, mult = free_join(q, {"Docs": docs, "Quality": qual, "Dedup": ded}, device=device)
    out = materialize(bound, mult, ("doc",))
    return np.unique(out["doc"])
