"""One rank of the multi-rank tests: spmd_count (tests/test_torch_distributed.py),
compressed_psum (tests/test_torch_train.py) and the LM over DTensors on
(1, 4) and (2, 2) meshes (tests/test_torch_tp.py).

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


# -- tensor parallelism (tests/test_torch_tp.py) ------------------------------

TP_MESHES = ((1, 4), (2, 2))
# (case, arch, experts): the reduced configs in fp32; "mixtral-e6" has six
# experts, which 4 model ranks do not divide (the split over the expert
# hidden dim) and 2 do (expert parallel)
TP_CASES = (("qwen2", "qwen2-1.5b", None), ("mixtral", "mixtral-8x22b", None),
            ("mixtral-e6", "mixtral-8x22b", 6), ("arctic", "arctic-480b", None),
            ("rwkv6", "rwkv6-1.6b", None), ("jamba", "jamba-1.5-large-398b", None))
TP_SEQ, TP_CUR = 8, 5


def tp_config(arch: str, experts):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch).reduced
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def tp_data(cfg, batch: int, seed: int) -> dict:
    """The train batch, the decode token and a random decode cache."""
    from repro_torch.models.transformer import init_cache

    rng = np.random.default_rng(seed)
    ints = lambda shape: torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32))
    cache = tuple(tuple(torch.from_numpy((0.5 * rng.standard_normal(tuple(leaf.shape)))
                                         .astype(np.float32)).to(leaf.dtype) for leaf in pos)
                  for pos in init_cache(cfg, batch, TP_SEQ, device="cpu"))
    return {"inputs": ints((batch, TP_SEQ)), "labels": ints((batch, TP_SEQ)),
            "token": ints((batch, 1)), "cache": cache}


def tp_plain(cfg, batch: int, seed: int) -> dict:
    """Loss, every gradient, and one decode step's logits and cache, on
    plain tensors."""
    from repro_torch.models.transformer import decode_step, init_params
    from repro_torch.train.trainer import loss_fn

    data = tp_data(cfg, batch, seed)
    params = init_params(cfg, seed=seed, device="cpu").requires_grad_()
    loss = loss_fn(params, cfg, data["inputs"], data["labels"])
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    logits, cache = decode_step(params, cfg, data["token"], data["cache"], TP_CUR)
    return {"loss": loss.detach(), "grads": dict(zip(names, grads)), "logits": logits,
            "cache": cache}


def tp_sharded(cfg, mesh, batch: int, seed: int) -> dict:
    """tp_plain's results with DTensor parameters, inputs and caches placed
    as the dry-run places them, the activation constraints set, gathered
    whole."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun, sharding
    from repro_torch.models import layers
    from repro_torch.models.transformer import decode_step, init_params
    from repro_torch.train.trainer import loss_fn

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    data = tp_data(cfg, batch, seed)
    params = dryrun.distribute_model(init_params(cfg, seed=seed, device="cpu"), mesh)
    params.requires_grad_()
    names = [n for n, _ in params.named_parameters()]
    with implicit_replication():
        try:
            dryrun._set_constraints(cfg, mesh, TP_SEQ, batch, "train")
            loss = loss_fn(params, cfg, dryrun.place_batch(data["inputs"], mesh),
                           dryrun.place_batch(data["labels"], mesh))
            grads = torch.autograd.grad(loss, list(params.parameters()))
            dryrun._set_constraints(cfg, mesh, TP_SEQ, batch, "decode")
            cache = tuple(tuple(distribute_tensor(leaf, *sh) for leaf, sh in zip(pos, shs))
                          for pos, shs in zip(data["cache"],
                                              sharding.cache_shardings(data["cache"], mesh)))
            logits, cache = decode_step(params, cfg, dryrun.place_batch(data["token"], mesh),
                                        cache, TP_CUR)
        finally:
            layers.clear_constraints()
        return {"loss": whole(loss).detach(),
                "grads": {n: whole(g) for n, g in zip(names, grads)},
                "logits": whole(logits),
                "cache": tuple(tuple(whole(leaf) for leaf in pos) for pos in cache)}


def tp_rank_main(rank: int, world: int, store_path: str, out_path: str, batch: int,
                 seed: int) -> None:
    """Every TP case on both meshes of 4 ranks; rank 0 saves the results."""
    from torch.distributed.device_mesh import init_device_mesh

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out = {}
        for shape in TP_MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for case, arch, experts in TP_CASES:
                out[(case, shape)] = tp_sharded(tp_config(arch, experts), mesh, batch, seed)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
