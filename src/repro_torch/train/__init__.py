"""Training on PyTorch: AdamW, the train step, data streams and corpus
selection, checkpoints in the reference's format, gradient compression
and the straggler policy."""
from repro_torch.train.optimizer import AdamWConfig, init_state, apply_updates, schedule
from repro_torch.train.trainer import TrainConfig, make_train_step, init_train_state, xent_loss
from repro_torch.train import checkpoint, compression, data, straggler

__all__ = [
    "AdamWConfig", "init_state", "apply_updates", "schedule",
    "TrainConfig", "make_train_step", "init_train_state", "xent_loss",
    "checkpoint", "compression", "data", "straggler",
]
