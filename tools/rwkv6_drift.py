#!/usr/bin/env python3
"""Where rwkv6-1.6b's fp32 logits drift: layer by layer against float64.

Run from the repository root on one NVIDIA GPU:

    python3 tools/rwkv6_drift.py [--seed 0] [--out FILE]

Makes rwkv6-1.6b at full width from --seed on the card, and the two
sequences chip_smoke.py's model phase checks it on: serve_trace(vocab,
seed + 1, n=2), each prompt followed by the 16 tokens a lone
DecodeServeEngine emits for it in fp32. Each sequence then goes through
the model four times: on the card and on the CPU in fp32, and on the CPU
and on the card in float64 (the weights `.double()`, compute_dtype
float64, and every `.float()` of the forward raised to float64 while that
evaluation runs: the wkv state, the decay, the norms, the unembedding).
For every layer it records the residual stream's largest magnitude and,
against the CPU's float64:

  * `card`, `cpu`: the accumulated error of the fp32 evaluations;
  * `card_local`, `cpu_local`: the error of that layer alone, fed the
    float64 input rounded to fp32 (the block, and its time mixer apart).

The logits get the same (also over the first and the last 8 positions),
with the card's fp32 against the CPU's (the difference chip_smoke.py
bounds). The head (the final norm and the unembedding) gets a row of
its own, `head`:

  * `card_local`, `cpu_local`: the head alone in fp32, fed the float64
    last hidden state rounded to fp32;
  * `card_hidden`, `cpu_hidden`: each fp32 evaluation's own last hidden
    state through the float64 head, i.e. the logits' error that the
    hidden state's error carries on its own. Prints one JSON line per sequence, and writes them all to
--out if given. `--reduced` runs the reduced config on the CPU
only (a rehearsal of the script, not a measurement).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


@contextmanager
def float64_forward():
    """Every `Tensor.float()` of the forward returns float64 instead."""
    import torch

    orig = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig


def block_outputs(params, cfg, seq):
    """The residual stream after every block, and the logits."""
    import torch

    from repro_torch.models import transformer as tf

    x = tf._embed(params, cfg, seq)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    unit = len(cfg.block_pattern)
    outs = []
    for i, blk in enumerate(params["blocks"]):
        x = tf._block_apply(cfg, i % unit, blk, x, positions)
        outs.append(x)
    return outs, head(params, cfg, x)


def head(params, cfg, x):
    """The final norm and the unembedding alone on hidden state x."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf

    x = tf._norm_apply(cfg, params["final_norm"], x)
    return layers.unembed_apply(params["embed"], x, cfg.tie_embeddings)


def one_block(params, cfg, i, x):
    """Block i alone on input x: (its time mixer's output, its output)."""
    import torch

    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf

    blk = params["blocks"][i]
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    h = tf._norm_apply(cfg, blk["ln1"], x)
    mixer = ssm.rwkv6_apply(blk["mixer"], cfg.rwkv_cfg, h)
    return mixer, tf._block_apply(cfg, i % len(cfg.block_pattern), blk, x, positions)


def err(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    if args.reduced:
        device, spec = "cpu", get_arch("rwkv6-1.6b").reduced
    elif not torch.cuda.is_available():
        print("rwkv6_drift: no CUDA device visible", file=sys.stderr)
        return 2
    else:
        device, spec = "cuda", get_arch("rwkv6-1.6b").model
    cfg = dataclasses.replace(spec, compute_dtype="float32")
    cfg64 = dataclasses.replace(spec, compute_dtype="float64")
    card = tf.init_params(spec, seed=args.seed, device=device)
    cpu = copy.deepcopy(card).to("cpu")
    cpu64 = copy.deepcopy(cpu).double()
    card64 = copy.deepcopy(card).double()
    card_name = "cpu" if device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card_name}; allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}, "
          f"CPU threads {torch.get_num_threads()}", flush=True)

    records = []
    trace = chip_smoke.serve_trace(cfg.vocab, args.seed + 1, n=2)
    for n, item in enumerate(trace):
        if device == "cpu":
            out = []
        else:
            out = chip_smoke.serve(card, cfg, [item])[1][0]
        seq = torch.from_numpy(np.concatenate([item[0], np.asarray(out, np.int32)]))[None]
        with torch.no_grad():
            card_x, card_logits = block_outputs(card, cfg, seq.to(device))
            cpu_x, cpu_logits = block_outputs(cpu, cfg, seq)
            with float64_forward():
                ref_x, ref_logits = block_outputs(cpu64, cfg64, seq)
                c64_x, c64_logits = block_outputs(card64, cfg64, seq.to(device))
            rows = []
            prev = tf._embed(cpu64, cfg64, seq)
            for i in range(cfg.num_layers):
                x32 = prev.float()
                with float64_forward():
                    ref_mixer, ref_block = one_block(cpu64, cfg64, i, prev)
                cm, cb = one_block(card, cfg, i, x32.to(device))
                pm, pb = one_block(cpu, cfg, i, x32)
                rows.append({
                    "layer": i, "scale": float(ref_x[i].abs().max()),
                    "card": err(card_x[i], ref_x[i]), "cpu": err(cpu_x[i], ref_x[i]),
                    "card64": err(c64_x[i], ref_x[i]),
                    "card_local": err(cb, ref_block), "cpu_local": err(pb, ref_block),
                    "card_local_mixer": err(cm, ref_mixer), "cpu_local_mixer": err(pm, ref_mixer)})
                prev = ref_x[i]
            last32 = ref_x[-1].float()
            with float64_forward():
                card_hidden = head(cpu64, cfg64, card_x[-1].cpu().double())
                cpu_hidden = head(cpu64, cfg64, cpu_x[-1].double())
            head_row = {"card_local": err(head(card, cfg, last32.to(device)), ref_logits),
                        "cpu_local": err(head(cpu, cfg, last32), ref_logits),
                        "card_hidden": err(card_hidden, ref_logits),
                        "cpu_hidden": err(cpu_hidden, ref_logits)}
        rec = {"sequence": n, "tokens": int(seq.shape[1]),
               "logit_scale": float(ref_logits.abs().max()),
               "logits_card_vs_cpu": err(card_logits, cpu_logits),
               "logits_card": err(card_logits, ref_logits), "logits_cpu": err(cpu_logits, ref_logits),
               "logits_card64": err(c64_logits, ref_logits),
               "logits_card_first8": err(card_logits[:, :8], ref_logits[:, :8]),
               "logits_cpu_first8": err(cpu_logits[:, :8], ref_logits[:, :8]),
               "logits_card_last8": err(card_logits[:, -8:], ref_logits[:, -8:]),
               "logits_cpu_last8": err(cpu_logits[:, -8:], ref_logits[:, -8:]),
               "head": head_row, "layers": rows}
        records.append(rec)
        print("rwkv6 drift: " + json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card_name,
                                              "cpu_threads": torch.get_num_threads(),
                                              "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
