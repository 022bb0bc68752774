"""Serve a small model with batched requests on the PyTorch/CUDA port:
continuous batching, paged KV bookkeeping, mixed prompt lengths.

  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

run() serves the 24 requests on given parameters and returns the steps,
each request's tokens and the free KV pages.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.serve import DecodeServeEngine, Request

N_REQ, MAX_NEW = 24, 32

CFG = ModelConfig(
    name="demo-serve",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=1024,
    vocab=512,
    compute_dtype="float32",
    remat=False,
)


def requests(cfg: ModelConfig) -> list[Request]:
    """24 requests, prompts of 4-23 tokens from default_rng(3), 32 new
    tokens each."""
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(4, 24))).astype(
        np.int32), max_new=MAX_NEW) for i in range(N_REQ)]


def run(params, cfg: ModelConfig, device) -> dict:
    """Serve the 24 requests with DecodeServeEngine(slots=8, max_len=256) on
    `params` (already on `device`)."""
    eng = DecodeServeEngine(params, cfg, slots=8, max_len=256)
    reqs = requests(cfg)
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"device": str(device), "steps": eng.steps, "tokens": [list(r.out) for r in reqs],
            "done": sum(r.done for r in reqs), "new_tokens": sum(len(r.out) for r in reqs),
            "free_pages": len(eng.pages.free), "num_pages": eng.pages.num_pages, "seconds": dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    params = init_params(CFG, seed=7, device=args.device)
    out = run(params, CFG, args.device)
    tok, dt = N_REQ * MAX_NEW, out["seconds"]
    where = (torch.cuda.get_device_name(torch.device(args.device))
             if torch.device(args.device).type == "cuda" else "CPU")
    print(f"served {N_REQ} requests / {tok} new tokens in {out['steps']} batched decode steps")
    print(f"{dt:.1f}s on {where} -> {tok / dt:.1f} tok/s; free KV pages: {out['free_pages']}")
    return out


if __name__ == "__main__":
    main()
