"""Lever log: one dry-run trace per (cell, levers) on the single-pod mesh,
its counts appended to build/perf_log.jsonl, so a hypothesis -> change ->
measure log is reproducible.

Levers, as the reference's: `remat` (the remat policy), `q_chunk` (query
chunk of attention), `microbatches`, `last_only` (prefill logits of the
last position only), and the MoE combine's activation constraint `moe_y`
as a spec ("dp,," -> (("data",), None, None)). The reference's `moe_buf`
and `moe_out` pin the dispatch and expert-output buffers; here those
buffers exist only inside the MoE layer's local-shard call
(models/tp.py), never as DTensors, so there is nothing for them to pin
and both raise rather than log a run that applied nothing. The
reference's while-body scaling of collective bytes has no counterpart:
eager PyTorch runs every layer, so the counts are direct.

  python -m repro_torch.launch.perf --arch mixtral-8x22b --shape train_4k \\
      --tag baseline [--moe-y dp,,] [--remat dots] [--last-only] ...
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import sharding as shard
from repro_torch.launch.dryrun import lower_program
from repro_torch.launch.mesh import fake_world, production_layout
from repro_torch.launch.roofline import LINK_BW


# the reference's levers that pin buffers the port never makes DTensors
_LOCAL_ONLY = ("moe_buf", "moe_out")


def _parse_spec(s: str) -> shard.P:
    """'dp,,model,' -> P(('data',), None, 'model', None); 'dp' means the
    data axes tuple, '' means None."""
    parts = []
    for tok in s.split(","):
        if tok == "":
            parts.append(None)
        elif tok == "dp":
            parts.append(("data",))
        else:
            parts.append(tok)
    return shard.P(*parts)


def measure(arch: str, shape: str, levers: dict, device: str = "cuda") -> dict:
    """One traced step of (arch, shape) at full width with `levers`, in a
    fake world of the single-pod mesh."""
    return measure_config(arch, get_arch(arch).model, shape, SHAPES[shape], levers,
                          production_layout(False)[0], device)


def measure_config(arch: str, cfg, shape: str, dims: tuple[int, int, str], levers: dict,
                   mesh_shape: tuple[int, ...], device: str) -> dict:
    """measure's record for `cfg` (full width or reduced) at dims = (seq,
    batch, kind) on a ("data", "model") mesh of `mesh_shape`."""
    spec = get_arch(arch)
    unpinnable = sorted(k for k in _LOCAL_ONLY if levers.get(k))
    if unpinnable:
        raise ValueError(f"{unpinnable}: the MoE dispatch and expert buffers live only on "
                         "local shards (models/tp.py), so no constraint can apply to them")
    if levers.get("remat"):
        cfg = dataclasses.replace(cfg, remat_policy=levers["remat"])
    if levers.get("q_chunk") is not None:
        cfg = dataclasses.replace(cfg, attn_q_chunk=levers["q_chunk"])
    seq, batch, kind = dims
    if kind == "decode":
        raise NotImplementedError("decode cells are not lever-tuned")
    with fake_world(math.prod(mesh_shape)):
        mesh = init_device_mesh(device, mesh_shape, mesh_dim_names=production_layout(False)[1])
        pinned = {name: (mesh, shard.placements(_parse_spec(levers[name]), mesh))
                  for name in ("moe_y",) if levers.get(name)}
        t0 = time.time()
        metrics, mem, _, calls = lower_program(
            spec, cfg, seq, batch, kind, mesh, device=device,
            microbatches=levers.get("microbatches", 1),
            last_only=bool(levers.get("last_only")), constraints=pinned)
    colls = metrics["collective_bytes"]
    return {
        "arch": arch,
        "shape": shape,
        "levers": levers,
        "compile_s": round(time.time() - t0, 1),  # trace seconds
        "flops_raw": metrics["flops"],
        "bytes_accessed": metrics["bytes_accessed"],
        "collective_bytes": colls,
        "collective_calls": calls,
        "collective_total": sum(colls.values()),
        "collective_s": sum(colls.values()) / LINK_BW,
        "memory": mem,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--moe-buf", default=None, help="the reference's lever; raises here")
    ap.add_argument("--moe-y", default=None)
    ap.add_argument("--moe-out", default=None, help="the reference's lever; raises here")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--last-only", action="store_true")
    ap.add_argument("--device", default="cuda", help="device type of the fake tensors")
    ap.add_argument("--log", default="build/perf_log.jsonl")
    args = ap.parse_args(argv)
    levers = {
        k: v
        for k, v in {
            "moe_buf": args.moe_buf,
            "moe_y": args.moe_y,
            "moe_out": args.moe_out,
            "remat": args.remat,
            "q_chunk": args.q_chunk,
            "microbatches": args.microbatches,
            "last_only": args.last_only,
        }.items()
        if not (v is None or v is False or (k == "microbatches" and v == 1))
    }
    rec = measure(args.arch, args.shape, levers, args.device)
    rec["tag"] = args.tag
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    with open(args.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(
        f"[{args.tag}] {args.arch}/{args.shape} flops_raw={rec['flops_raw']:.3e} "
        f"coll={rec['collective_total']:.3e}B ({rec['collective_s']:.2f}s) "
        f"temp={(rec['memory'].get('temp_size_in_bytes') or 0) / 1e9:.1f}GB "
        f"trace={rec['compile_s']}s"
    )
    for op, b in sorted(rec["collective_bytes"].items(), key=lambda kv: -kv[1]):
        print(f"    {op:20s} {b:.3e} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
