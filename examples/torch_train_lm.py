"""End-to-end driver on the PyTorch/CUDA port: train a small LM for a few
hundred steps, with checkpoint/resume and a demonstrably decreasing loss
(Markov data).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 150] [--resume-demo] [--device cpu]

main() returns the losses, the checkpoint directory and what the resume
restored.
"""
import argparse
import tempfile

import torch

from repro_torch.models.transformer import ModelConfig
from repro_torch.train import AdamWConfig, TrainConfig, checkpoint, make_train_step
from repro_torch.train.data import DataConfig, markov_batch
from repro_torch.train.trainer import init_train_state

# 1.8M parameters (the name is the reference's): a few hundred steps finish in
# seconds on one card and in a minute on a CPU; scale num_layers/d_model up freely.
CFG = ModelConfig(
    name="demo-7m",
    num_layers=3,
    d_model=192,
    num_heads=6,
    num_kv_heads=3,
    d_ff=768,
    vocab=512,
    compute_dtype="float32",
    remat=False,
)


def state_leaves(params, opt) -> list:
    return [*params.parameters(), *opt["m"].parameters(), *opt["v"].parameters(), opt["step"]]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--resume-demo", action="store_true", help="kill + resume mid-run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None, help="default: a fresh temporary directory")
    args = ap.parse_args(argv)

    cfg, dev = CFG, torch.device(args.device)
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps))
    params, opt = init_train_state(cfg, tcfg, seed=0, device=dev)
    n = sum(p.numel() for p in params.parameters())
    print(f"model: {n / 1e6:.1f}M params")
    # the step updates params and opt in place: nothing to donate
    step_fn = make_train_step(cfg, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=96, global_batch=8)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-torch-ckpt-")
    losses, resume = [], None
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in markov_batch(dcfg, step).items()}
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 50 == 0:
            print(f"step {step + 1:4d}  loss {losses[-1]:.4f}  lr {float(m['lr']):.2e}")
            checkpoint.save(ckpt_dir, step + 1, {"params": params, "opt": opt}, cfg)
        if args.resume_demo and step == args.steps // 2:
            checkpoint.save(ckpt_dir, step + 1, {"params": params, "opt": opt}, cfg)
            print("-- simulating failure: restoring from latest checkpoint --")
            latest = checkpoint.latest_step(ckpt_dir)
            # a restarted process: a state from another seed, restored over
            fresh = init_train_state(cfg, tcfg, seed=1, device=dev)
            state = checkpoint.restore(ckpt_dir, latest, {"params": fresh[0], "opt": fresh[1]},
                                       cfg)
            exact = all(torch.equal(a, b) for a, b in zip(
                state_leaves(params, opt), state_leaves(state["params"], state["opt"])))
            params, opt = state["params"], state["opt"]
            resume = {"at_step": step + 1, "restored_step": latest, "bit_exact": exact}
    first, last = losses[0], losses[-1]
    verdict = "LEARNED" if last < first - 0.5 else "check hyperparams"
    print(f"\nloss: {first:.3f} -> {last:.3f} ({verdict})")
    return {"device": str(dev), "steps": args.steps, "params": n, "losses": losses,
            "verdict": verdict, "resume": resume, "ckpt_dir": ckpt_dir,
            "state": (params, opt)}


if __name__ == "__main__":
    main()
