"""End-to-end training launcher.

Reduced configs by default; fault tolerance: resumes from the latest
checkpoint; the data stream is a pure function of step, so resume is exact.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 200 --reduced --batch 8 --seq 64

Runs on the card (`--device cuda`, the default) unless `--device cpu` asks
for the CPU; with no card visible and no `--device cpu`, it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models.transformer import resolve_device
from repro_torch.train import AdamWConfig, TrainConfig, checkpoint, make_train_step
from repro_torch.train.data import DataConfig, markov_batch
from repro_torch.train.straggler import StragglerMonitor
from repro_torch.train.trainer import init_train_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.model
    tcfg = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps),
        microbatches=args.microbatches,
    )
    params, opt_state = init_train_state(cfg, tcfg, seed=0, device=device)
    start = 0
    if args.ckpt_dir:
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            checkpoint.restore(args.ckpt_dir, latest, {"params": params, "opt": opt_state}, cfg)
            start = latest
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)
    mon = StragglerMonitor(num_hosts=1)
    t_hist = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in markov_batch(dcfg, step).items()}
        if spec.modality != "text":  # stub frontend: embed ids as floats
            emb = F.one_hot((batch["inputs"] % cfg.d_model).long(), cfg.d_model).float()
            batch = {"inputs": emb, "labels": batch["labels"]}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        t_hist.append(time.time() - t0)
        if (step + 1) % args.log_every == 0:
            print(
                f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.2f} "
                f"{t_hist[-1] * 1e3:.0f} ms"
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state}, cfg)
        if len(t_hist) >= 20:
            mon.observe(np.array([sum(t_hist) / len(t_hist)]))
            t_hist = []
    print("done")
    return params


if __name__ == "__main__":
    main()
