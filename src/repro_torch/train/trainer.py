"""Train step: xent loss, microbatch gradient accumulation, mixed
precision, AdamW; the function launch/train.py runs and chip_smoke.py
times on the card.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import tp
from repro_torch.models.transformer import ModelConfig, apply_model, init_params
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = dataclasses.field(default_factory=opt.AdamWConfig)
    microbatches: int = 1  # split the global batch, accumulate grads


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in fp32. labels -100 are masked."""
    if isinstance(logits, DTensor):
        return tp.xent_loss(logits, labels)
    mask = labels >= 0
    labels_safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels_safe[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)


def loss_fn(params, cfg: ModelConfig, inputs, labels) -> torch.Tensor:
    return xent_loss(apply_model(params, cfg, inputs), labels)


def _loss_and_grads(params, cfg: ModelConfig, inputs, labels):
    leaves = list(params.parameters())
    loss = loss_fn(params, cfg, inputs, labels)
    return loss.detach(), torch.autograd.grad(loss, leaves, materialize_grads=True)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), which updates params and opt_state in place. batch =
    {"inputs": (B, S[, D]), "labels": (B, S)} tensors on params' device;
    params' leaves must require gradients (init_train_state makes them
    so). metrics {"loss", "lr", "grad_norm"} are tensors on the device:
    the step reads nothing back."""

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatches
        if mb == 1:
            loss, grads = _loss_and_grads(params, cfg, batch["inputs"], batch["labels"])
        else:
            b = batch["inputs"].shape[0]
            if b % mb:
                raise ValueError(f"batch {b} is not divisible into {mb} microbatches")
            # the raw microbatch grads summed in fp32, then divided by mb,
            # as the reference's scan over microbatches does
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in params.parameters()]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for i in range(mb):
                part = slice(i * b // mb, (i + 1) * b // mb)
                loss_i, grads_i = _loss_and_grads(params, cfg, batch["inputs"][part],
                                                  batch["labels"][part])
                loss = loss + loss_i
                for acc, g in zip(grads, grads_i):
                    acc.add_(g)
                del grads_i
            loss = loss / mb
            grads = [g / mb for g in grads]
        params, opt_state, metrics = opt.apply_updates(tcfg.adamw, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, device=None):
    """(params with gradients on, AdamW state) from `seed`, on `device`
    (default: the card)."""
    params = init_params(cfg, seed=seed, device=device).requires_grad_()
    return params, opt.init_state(tcfg.adamw, params)
