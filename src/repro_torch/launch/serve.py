"""Decode serving from the command line: continuous batching over an arch's
reduced config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --requests 8

Runs on the card (`--device cuda`, the default) unless `--device cpu` asks
for the CPU; with no card visible and no `--device cpu`, it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_arch
from repro_torch.models.transformer import init_params, resolve_device
from repro_torch.serve import DecodeServeEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced
    params = init_params(cfg, seed=0, device=device)
    eng = DecodeServeEngine(params, cfg, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(2, 12))).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(
        f"served {args.requests} requests ({toks} tokens) in {eng.steps} engine steps,"
        f" {dt:.2f}s ({toks / dt:.1f} tok/s on {device.type}, reduced config)"
    )
    return eng


if __name__ == "__main__":
    main()
