"""The port's LM dry-run (repro_torch.launch.dryrun) on the CPU: reduced
configs traced on small fake worlds, each record in the reference's
schema and read by both packages' roofline.analyse; the activation
constraints leave plain-tensor results bit for bit; and the program the
dry-run traces runs: one train step with DTensor parameters on a (1, 1)
mesh of a real gloo group against the plain step."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro.launch import roofline as r_roofline
from repro_torch import configs as p_configs
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import fake_world
from repro_torch.models import layers, transformer as p_tf
from repro_torch.train import optimizer as p_opt
from repro_torch.train import trainer as p_trainer


def reduced(arch: str):
    return dataclasses.replace(p_configs.get_arch(arch).reduced)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b", "rwkv6-1.6b"])
def test_constraints_leave_plain_tensors_bit_identical(arch):
    with fake_world(8):
        _constrained_equal(arch)


def _constrained_equal(arch):
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduced(arch), remat=False)
    params = p_tf.init_params(cfg, seed=3, device="cpu")
    x = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32)
    if p_configs.get_arch(arch).modality != "text":
        x = torch.randn(2, 8, cfg.d_model)
    want = p_tf.apply_model(params, cfg, x)
    try:
        dryrun._set_constraints(cfg, mesh, 8, 2, "prefill")
        got = p_tf.apply_model(params, cfg, x)
    finally:
        layers.clear_constraints()
    assert torch.equal(got, want)


REF_KEYS = {"arch", "shape", "multi_pod", "status", "mesh", "seconds_to_compile", "raw",
            "memory", "memory_mb8", "params_total", "repeats", "unit_layers", "flops",
            "bytes_accessed", "collective_bytes"}


@pytest.mark.parametrize("arch,shape,dims", [
    ("qwen2-1.5b", "train_4k", (16, 8, "train")),
    ("mixtral-8x22b", "prefill_32k", (16, 8, "prefill")),
    ("rwkv6-1.6b", "decode_32k", (16, 8, "decode")),
    ("jamba-1.5-large-398b", "long_500k", (32, 1, "decode")),
])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_lower_cell_reduced_record(arch, shape, dims, multi_pod):
    # the microbatches=8 trace once, on the single-pod mesh
    rec = dryrun.trace_cell(arch, reduced(arch), shape, dims, multi_pod,
                            (2, 2, 2) if multi_pod else (2, 4), "cpu", mb8=not multi_pod)
    assert not dist.is_initialized()
    assert set(rec) == REF_KEYS
    assert rec["status"] == "ok" and rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["mesh"] == ({"pod": 2, "data": 2, "model": 2} if multi_pod
                           else {"data": 2, "model": 4})
    assert set(rec["collective_bytes"]) <= {"all-gather", "all-reduce", "reduce-scatter",
                                            "all-to-all"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert (rec["memory_mb8"] is not None) == (dims[2] == "train" and not multi_pod)
    # both packages' analyse read the record
    for mod in (roofline, r_roofline):
        a = mod.analyse(rec)
        assert a["arch"] == arch and a["chips"] == 8 and a["dominant"] in (
            "compute", "memory", "collective")


def test_dtensor_train_step_on_one_rank_matches_plain(tmp_path):
    """The program the dry-run traces runs: one train step with DTensor
    parameters on a (1, 1) mesh of a real gloo group against the plain
    step on the same batch."""
    cfg = reduced("qwen2-1.5b")
    tcfg = p_trainer.TrainConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    y = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
    plain, state = p_trainer.init_train_state(cfg, tcfg, seed=1, device="cpu")
    _, _, want = p_trainer.make_train_step(cfg, tcfg)(plain, state, {"inputs": x, "labels": y})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        params = p_tf.init_params(cfg, seed=1, device="cpu")
        dryrun.distribute_model(params, mesh).requires_grad_()
        state = p_opt.init_state(tcfg.adamw, params)
        batch = {k: dryrun.place_batch(v, mesh) for k, v in (("inputs", x), ("labels", y))}
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            _, _, got = p_trainer.make_train_step(cfg, tcfg)(params, state, batch)
        loss, gn = (t.full_tensor() if isinstance(t, DTensor) else t
                    for t in (got["loss"], got["grad_norm"]))
    finally:
        dist.destroy_process_group()
    # the vocab-parallel loss takes the log-sum-exp in another order than
    # log_softmax: fp32 rounding, nothing more
    assert abs(float(loss) - float(want["loss"])) <= 1e-6 * abs(float(want["loss"]))
    assert abs(float(gn) - float(want["grad_norm"])) <= 1e-5 * abs(float(want["grad_norm"]))
