"""The two pillars together on the PyTorch/CUDA port: the Free Join engine
running the *framework's* relational work, corpus sample selection for LM
training and distributed (HyperCube) counting of a graph statistic.

  PYTHONPATH=src python examples/torch_analytics_pipeline.py [--device cpu]

main() returns the kept documents, the first batch's shapes, the HyperCube
shares and the triangle count.
"""
import argparse

import numpy as np

from repro_torch.core.distributed import distributed_join_host, hypercube_shares
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from repro_torch.train.data import DataConfig, select_corpus_samples, synthetic_batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n_docs = 200_000
    docs = Relation(
        "Docs",
        {
            "doc": np.arange(n_docs, dtype=np.int64),
            "shard": rng.integers(0, 64, n_docs),
            "lang": rng.integers(0, 30, n_docs),
        },
    )
    quality = Relation(
        "Quality",
        {"doc": np.arange(n_docs, dtype=np.int64), "score": rng.integers(0, 100, n_docs)},
    )
    canonical = np.arange(n_docs, dtype=np.int64)
    dup = rng.random(n_docs) < 0.2  # 20% duplicates point elsewhere
    canonical[dup] = rng.integers(0, n_docs, int(dup.sum()))
    dedup = Relation("Dedup", {"doc": np.arange(n_docs, dtype=np.int64), "canonical": canonical})

    # the eager Free Join on the device: the kernels build the tries, probe
    # and expand
    keep = select_corpus_samples(docs, quality, dedup, min_quality=60, device=args.device)
    print(f"corpus selection: kept {len(keep):,} / {n_docs:,} docs "
          f"(quality>=60 and canonical) via Free Join on {args.device}")

    # feed the kept set into the deterministic batch stream
    dcfg = DataConfig(vocab=32000, seq_len=64, global_batch=8)
    batch = synthetic_batch(dcfg, step=0)
    print(f"first batch: inputs {batch['inputs'].shape}, labels {batch['labels'].shape}")

    # distributed analytics: triangle count over a follow graph, HyperCube
    # partitioned on the host, each shard's join on the device
    n_edges, n_people = 60_000, 8_000
    knows = Relation(
        "knows",
        {"a": rng.integers(0, n_people, n_edges), "b": rng.integers(0, n_people, n_edges)},
    )
    q = Query(
        [
            Atom("knows", ("a", "b"), "K1"),
            Atom("knows", ("b", "c"), "K2"),
            Atom("knows", ("c", "a"), "K3"),
        ]
    )
    rels = {
        "K1": knows,
        "K2": knows.rename({"a": "b", "b": "c"}),
        "K3": knows.rename({"a": "c", "b": "a"}),
    }
    shares = hypercube_shares(q, {k: n_edges for k in rels}, 8)
    count = distributed_join_host(q, rels, num_shards=8, agg="count", device=args.device)
    print(f"triangle count over 8 HyperCube shards (shares={shares}): {count:,}")
    return {"device": args.device, "docs": n_docs, "kept": keep,
            "batch_shapes": {k: tuple(v.shape) for k, v in batch.items()},
            "shares": shares, "triangles": count,
            "relations": {"docs": docs, "quality": quality, "dedup": dedup, "knows": knows}}


if __name__ == "__main__":
    main()
