"""Production mesh builders.

Functions, not module-level constants: importing this module touches no
device or process-group state. The caller owns the process group: a real
one (NCCL, one process a card) or, for a dry-run, `fake_world`, one process
standing in for every rank.

Single pod: 16x16 = 256 cards, axes (data, model).
Multi-pod:  2x16x16 = 512 cards, axes (pod, data, model); the pod axis is
pure data parallelism across the slow boundary between pods.
The shapes are the reference's, kept for parity. On H100 nodes of 8 cards a
16-wide "model" axis spans two NVLink domains, so half of its links are
the slower links between nodes.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_layout(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape, axes = production_layout(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def dp_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """Axes used for data parallelism / FSDP."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_host_mesh(num_devices: int | None = None, axis: str = "data") -> DeviceMesh:
    """1-D mesh over the visible cards (tests, examples); the process group
    must span `num_devices` ranks."""
    n = num_devices or torch.cuda.device_count()
    return init_device_mesh("cuda", (n,), mesh_dim_names=(axis,))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of `world_size` ranks held by this one
    process as rank 0, on torch's "fake" backend: collectives return at
    once and move nothing, so a program can be traced for a cluster that
    is not there. Torn down on exit."""
    # FakeStore lives in torch's testing tree: a store that holds nothing
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
