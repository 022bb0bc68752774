"""One rank of the multi-rank tests: spmd_count (tests/test_torch_distributed.py)
and compressed_psum (tests/test_torch_train.py).

Not a test module: the tests spawn these functions once per rank, so it
imports only torch and the port. Each rank joins a gloo group over a
FileStore, runs the port on the CPU over the shared workload, and writes
what it saw to a JSON file.
"""
import json

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.plan import binary2fj, factor
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import triangle_query


def workload(seed: int, n: int = 300, dom: int = 8):
    """The triangle over random relations: (query, relations, plan)."""
    rng = np.random.default_rng(seed)
    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, dom, n) for v in a.vars})
            for a in q.atoms}
    return q, rels, factor(binary2fj(q.atoms, q))


def spmd_records(q, rels, fj, num_shards: int, group=None) -> list[dict]:
    """spmd_count with the planner's capacities, then with undersized
    manual ones (the retry loop must grow them): one record per call."""
    out = []
    for capacities in (None, [16] * 4):
        info = {}
        count = D.spmd_count(q, rels, fj, capacities, num_shards=num_shards, group=group,
                             device="cpu", info=info)
        out.append({"count": count, "cap_plan": str(info["cap_plan"]),
                    "retries": info["retries"], "shares": info["shares"]})
    return out


def rank_main(rank: int, world: int, store_path: str, num_shards: int, seed: int,
              out_path: str) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        q, rels, fj = workload(seed)
        records = spmd_records(q, rels, fj, num_shards)
        with open(out_path, "w") as f:
            json.dump({"records": records, "collectives": D.COLLECTIVES}, f)
    finally:
        dist.destroy_process_group()


def compression_grad(world: int) -> np.ndarray:
    """The reference's compression workload: row r is rank r's gradient."""
    return (np.arange(world * 8, dtype=np.float32).reshape(world, 8) / np.float32(7.3))


def compression_rank_main(rank: int, world: int, store_path: str, out_path: str) -> None:
    """Two compressed_psum steps of rank `rank`'s row, the second carrying
    the first's error state; writes each step's output and error."""
    from repro_torch.train.compression import compressed_psum, init_error

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        grad = {"w": torch.from_numpy(compression_grad(world)[rank:rank + 1])}
        err = init_error(grad)
        steps = []
        for _ in range(2):
            out, err = compressed_psum(grad, err)
            steps.append({"out": out["w"].tolist(), "err": err["w"].tolist()})
        with open(out_path, "w") as f:
            json.dump(steps, f)
    finally:
        dist.destroy_process_group()
