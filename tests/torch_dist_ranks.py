"""One rank of the multi-rank spmd_count test (tests/test_torch_distributed.py).

Not a test module: the test spawns this function once per rank, so it
imports only torch and the port. Each rank joins a gloo group over a
FileStore, runs spmd_count on the CPU over the shared workload, and
writes what it saw to a JSON file.
"""
import json

import numpy as np
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
