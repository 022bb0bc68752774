"""Roofline analysis over the dry-run records (launch/dryrun.py output),
on the H100's constants.

Per (arch, shape, mesh):
    compute term    = flops_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw
plus MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (prefill/decode),
N counted from the parameters' shapes, D the tokens of a shape in
configs.SHAPES, and the useful-compute ratio MODEL_FLOPS / (flops *
cards). chip_smoke.py also divides MODEL_FLOPS by a measured step time and
the bf16 peak for the training step's MFU.

Hardware constants (NVIDIA H100 SXM data sheet, dense, at 700 W): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, and NVLink 4 at 450 GB/s
per direction per GPU (900 GB/s bidirectional). An axis that leaves an
8-card node runs over the slower network between nodes, so the
collective term is a lower bound there.

Caveats recorded with the table:
  * the dry-run's bytes are the input plus output bytes of every local op
    (no fusion seen): the memory term is an upper bound;
  * collective bytes are summed result sizes of the collectives one rank
    issues (an all-reduce counted once, not 2(P-1)/P ring passes).

The records are the reference's schema, so this module's `analyse` reads
the reference's records too, and the reference's reads these.

Usage: python -m repro_torch.launch.roofline [--dir build/dryrun] [--multi-pod]
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

PEAK_FLOPS = 989e12  # bf16 / card
HBM_BW = 3.35e12  # B/s / card
LINK_BW = 450e9  # B/s / card, NVLink 4, one direction

from repro_torch.configs import SHAPES, get_arch  # noqa: E402


def param_count(cfg) -> int:
    """Parameters of `cfg`'s model, from their shapes: the parameters are
    made as fake (meta-backed) tensors, so nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_params

    with FakeTensorMode():
        return sum(p.numel() for p in init_params(cfg, device="cpu").parameters())


def model_flops(arch: str, shape: str) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for
    forward-only (per decoded token for decode shapes)."""
    cfg = get_arch(arch).model
    seq, batch, kind = SHAPES[shape]
    total = param_count(cfg)
    if cfg.moe is not None:
        # subtract inactive expert params
        m = cfg.moe
        moe_layers = sum(
            1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i % len(cfg.block_pattern))
        )
        expert_params = moe_layers * m.num_experts * (
            (2 * cfg.d_model * m.d_ff) + (m.d_ff * cfg.d_model)
        )
        active = total - expert_params + expert_params * (m.top_k / m.num_experts)
    else:
        active = total
    tokens = batch * seq if kind != "decode" else batch  # decode: 1 token/seq
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


def load(dir_: str, multi_pod: bool = False) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("multi_pod") != multi_pod:
            continue
        recs.append(r)
    return recs


def analyse(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    flops = rec["flops"]
    comp = flops / PEAK_FLOPS
    memb = rec["bytes_accessed"] / HBM_BW
    collb = sum(rec["collective_bytes"].values()) / LINK_BW
    mf = model_flops(rec["arch"], rec["shape"])
    useful = mf / (flops * chips) if flops else 0.0
    dom = max((comp, "compute"), (memb, "memory"), (collb, "collective"))[1]
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "chips": chips,
        "compute_s": comp,
        "memory_s": memb,
        "collective_s": collb,
        "dominant": dom,
        "model_flops": mf,
        "useful_ratio": useful,
        "roofline_fraction": useful,  # of the compute roof, per card
        "temp_gb": (rec.get("memory_mb8") or rec.get("memory", {})).get("temp_size_in_bytes", 0)
        / 1e9
        if rec.get("memory")
        else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = []
    for rec in load(args.dir, args.multi_pod):
        if rec.get("status") == "skipped":
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "dominant": "N/A",
                         "why": rec.get("why", "")})
            continue
        a = analyse(rec)
        if a:
            rows.append(a)
        else:
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "dominant": "FAILED",
                         "why": rec.get("error", "")})
    print(f"{'arch':24s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s}"
          f" {'coll_s':>10s} {'dominant':>10s} {'useful':>7s}")
    for r in rows:
        if "compute_s" in r:
            print(f"{r['arch']:24s} {r['shape']:12s} {r['compute_s']:10.4f} {r['memory_s']:10.4f}"
                  f" {r['collective_s']:10.4f} {r['dominant']:>10s} {r['useful_ratio']:7.1%}")
        else:
            print(f"{r['arch']:24s} {r['shape']:12s} {'-':>10s} {'-':>10s} {'-':>10s}"
                  f" {r['dominant']:>10s}  {r.get('why', '')[:40]}")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted({k for r in rows for k in r}))
            w.writeheader()
            w.writerows(rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
