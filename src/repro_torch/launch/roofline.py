"""Analytic model FLOPs on the H100's roofline.

MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (prefill/decode): N
counted from the parameters' shapes, D the tokens of a shape in
configs.SHAPES. chip_smoke.py divides it by a measured step time and the
bf16 peak for the training step's MFU.

Hardware constants (NVIDIA H100 SXM data sheet, dense, at 700 W): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 / card
HBM_BW = 3.35e12  # B/s / card

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
