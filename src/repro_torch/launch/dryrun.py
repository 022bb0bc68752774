"""Multi-pod dry-run: trace every (arch x shape x mesh) cell at full width
on a 256- or 512-rank world faked in one process.

Per cell this shows, without the cluster:
  * the sharding config is coherent: every op of one step has a DTensor
    sharding rule on the production mesh (or is redistributed to one),
  * what one rank holds and makes (the memory record),
  * and the roofline terms consumed by launch/roofline.py.

How: `fake_world` opens torch's "fake" process group (collectives return
at once and move nothing), the production mesh lays the ranks out, and
the parameters, AdamW moments, inputs and caches are DTensors placed by
launch/sharding.py, their storage fake (FakeTensorMode: shapes, dtypes and
devices, no bytes). One step then runs as the port runs it: `train` is
`make_train_step` with AdamW moments in the arch's `opt_dtype`, `prefill`
is `apply_model`, `decode` is `decode_step` on `init_cache(batch,
min(seq, sliding_window))`. The step runs under `implicit_replication()`:
the constants the model makes (positions, masks, the step counter) are
plain tensors, read as replicated.

The counts are rank 0's, taken below DTensor's dispatch, where the local
shards' ops run (`OpCounter`; DTensor hands those ops back to the fake
mode):
  * flops: the local products (torch.utils.flop_counter's rules: mm, bmm,
    addmm, baddbmm, convolutions, attention), elementwise work excluded;
  * bytes_accessed: input plus output bytes of every local op that is not
    a view. Like XLA's CPU cost model this sees no fusion: an upper bound
    on HBM traffic;
  * collective_bytes: result bytes of every collective, by kind
    (all-gather, all-reduce, reduce-scatter, all-to-all), as the
    reference's HLO parser sums them;
  * memory: the local bytes of the step's arguments (parameters, moments,
    inputs, caches) and the peak of the bytes the step allocates on top
    of them (`temp_size_in_bytes`); `memory_mb8` the same for train cells
    at microbatches=8.
Eager PyTorch runs every layer, so there is no scan body to correct: the
reference's R=1/R=2 probes have no counterpart, and `flops` is the direct
count over all layers. Two loops inside a layer are the exception: the
rwkv6 recurrence over time and mamba's loop over chunks repeat one step
of identical shapes and placements thousands of times, so one step is
traced, through models/ssm.py's `scans` hook, and its flops, bytes and
collectives are counted once for each repeat, forward and backward
(`_repeated`). The traced step is not the model's own loop: it ties the
next state into its output (times zero) so that its backward reaches
what a middle step's does, and it returns the one step's output
repeated. So the memory record of rwkv6, mamba and jamba cells is an
estimate, not a trace: the bytes the other repeats would hold alive
(outputs and saved autograd state, extrapolated from the one step) are
allocated as one synthetic buffer until the backward starts.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import sharding as shard
from repro_torch.launch.mesh import fake_world, production_layout
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.transformer import apply_model, decode_step, init_cache, init_params
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.trainer import TrainConfig, make_train_step

# collective op name prefix -> the reference's HLO kind
_COLL_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
               ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
               ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
               ("alltoall", "all-to-all"))
_COLL_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")
# ops that move no bytes of their own
_NO_TRAFFIC = {"detach", "empty", "empty_strided", "empty_like", "lift_fresh", "alias"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(FakeTensorMode):
    """FakeTensorMode that counts, while `counting` is on, the ops on plain
    (local) fake tensors: DTensor's local computations and collectives, not
    the DTensor-level ops (those it hands back to DTensor) and not the
    global-shape ops DTensor's sharding propagation runs to infer shapes."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)  # the mesh holds real rank tensors
        self.counting = False
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, int] = {}
        self.collective_calls: dict[str, int] = {}
        self._weight = 1
        self._depth = 0
        self._paused = 0
        self._args: set[int] = set()
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    @contextlib.contextmanager
    def weighted(self, n: int):
        """Count every op inside as n ops (one traced step of n alike)."""
        old, self._weight = self._weight, self._weight * n
        try:
            yield
        finally:
            self._weight = old

    @contextlib.contextmanager
    def measuring(self, args):
        """Count from here; `args` (a tree of tensors or DTensors) are the
        step's arguments: their storage is not counted as temporaries."""
        for t in _tensors(args):
            local = t.to_local() if isinstance(t, DTensor) else t
            self._args.add(StorageWeakRef(local.untyped_storage()).cdata)
        prop = ShardingPropagator._propagate_tensor_meta_non_cached

        def paused(*a, **k):
            self._paused += 1
            try:
                return prop(*a, **k)
            finally:
                self._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        self.counting = True
        try:
            yield self
        finally:
            self.counting = False
            ShardingPropagator._propagate_tensor_meta_non_cached = prop

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._depth or self._paused or not self.counting:
            return super().__torch_dispatch__(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if out is not NotImplemented:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        ns, name = func.namespace, func._opname
        if ns == "prim":
            return
        outs = _tensors(out)
        w = self._weight
        if ns in _COLL_NAMESPACES:
            for prefix, kind in _COLL_KINDS:
                if name.startswith(prefix):
                    self.collectives[kind] = self.collectives.get(kind, 0) + w * sum(
                        _nbytes(t) for t in outs)
                    self.collective_calls[kind] = self.collective_calls.get(kind, 0) + w
                    break
        else:
            rule = flop_registry.get(func._overloadpacket)
            if rule is not None:
                self.flops += w * rule(*args, **kwargs, out_val=out)
            if not func.is_view and name not in _NO_TRAFFIC:
                ins = _tensors((args, kwargs))
                self.bytes += w * (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        ref = StorageWeakRef(st)
        key = ref.cdata
        if key in self._args:
            return
        known = self._live.get(key)
        if known is not None and not known[0].expired():
            return
        n = st.nbytes()
        self._live[key] = (ref, n)
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def allocate(self, nbytes: int) -> torch.Tensor:
        """A fake buffer of nbytes, tracked as a temporary while it lives."""
        buf = torch.empty((nbytes,), dtype=torch.uint8)
        self._track(buf)
        return buf

    def settled_bytes(self) -> int:
        self._sweep()
        return self.live_bytes

    def _sweep(self):
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]


def _repeated(counter: OpCounter, n: int, fn, *xs):
    """fn(*xs), traced once and counted as n alike steps: its ops with
    weight n, and so are the ops of its backward (hooks on the autograd
    nodes between its output and xs). Where gradients are on, the bytes
    one step leaves alive (its output and the autograd state it saves) are
    allocated for the other n - 1 steps too, until the step's backward
    starts, so the memory record holds them."""
    before = counter.settled_bytes()
    with counter.weighted(n):
        out = fn(*xs)
    if out.grad_fn is None:
        return out
    others = [counter.allocate((n - 1) * max(0, counter.settled_bytes() - before))]

    def enter(*_):
        others.clear()
        counter._weight *= n

    def leave(*_):
        counter._weight //= n

    stop = {x.grad_fn for x in xs if isinstance(x, torch.Tensor)}
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in stop or node in seen or not node.next_functions:
            continue  # a leaf's AccumulateGrad has no next functions: not the step's
        seen.add(node)
        node.register_prehook(enter)
        node.register_hook(leave)
        todo += [f for f, _ in node.next_functions]
    return out


def _repeated_loops(counter: OpCounter):
    """The rwkv6 time loop and mamba's chunk loop as one traced step
    counted as all of them, through ssm's `scans` hook (see the module
    docstring)."""

    def carried(state, *xs):
        """The carried state as a later step sees it: with a gradient where
        the inputs have one (the first step's zeros have none)."""
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in xs)
        return state.detach().requires_grad_(grad)

    def wkv_step(state, r, k, v, w, u):
        state, o = ssm._wkv_step(state, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
        # with gradients, the next state tied in (times zero): its backward
        # then reaches the decay and the carried state as a middle step's does
        return o + 0 * state[..., 0, :] if torch.is_grad_enabled() else o

    def wkv(state, r, k, v, w, u):
        s = r.shape[1]
        o = _repeated(counter, s, wkv_step, carried(state, r, k, v, w), r, k, v, w, u)
        return o[:, None].expand(o.shape[0], s, *o.shape[1:]).contiguous()  # the stack

    def chunk_scan(h0, da, dbx, ck):
        aa, bb = ssm._linear_scan(da[:, :ck], dbx[:, :ck])
        return aa * h0[:, None] + bb

    def mamba(da, dbx, cfg):
        b, s, di, n = da.shape
        ck = min(cfg.chunk, s)
        nc = s // ck
        assert nc * ck == s, f"seq {s} must be divisible by chunk {ck}"
        h0 = carried(torch.zeros_like(da[:, 0]), da, dbx)
        h = _repeated(counter, nc, chunk_scan, h0, da, dbx, ck)
        return h.repeat(1, nc, 1, 1)  # the concatenation

    return ssm.scans(mamba=mamba, wkv=wkv)


def distribute_model(model, mesh, specs=None):
    """`model` with every parameter a DTensor placed by `param_spec` (or by
    `specs[name]`, (mesh, placements) pairs, where given), in place."""
    specs = specs or shard.param_shardings(model, mesh)
    for mod_name, mod in model.named_modules():
        for k, p in list(mod._parameters.items()):
            name = f"{mod_name}.{k}" if mod_name else k
            d = distribute_tensor(p.detach(), *specs[name])
            mod._parameters[k] = torch.nn.Parameter(d, requires_grad=p.requires_grad)
    return model


def place_batch(t: torch.Tensor, mesh) -> DTensor:
    """An input batch as a DTensor placed by batch_spec."""
    return distribute_tensor(t, mesh, shard.placements(shard.batch_spec(tuple(t.shape), mesh),
                                                        mesh))


def _set_constraints(cfg, mesh, seq: int, batch: int, kind: str):
    """Pin the activation shardings propagation won't find on its own: the
    residual stream (batch over dp axes) and the logits (vocab over model)."""
    L.clear_constraints()
    s = 1 if kind == "decode" else seq
    act = shard.batch_spec((batch, s, cfg.d_model), mesh)
    bdim = act[0] if len(act) else None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

    def put(name, spec):
        L.set_constraint(name, (mesh, shard.placements(spec, mesh)))

    put("act" if kind != "decode" else "act_dec", act)
    if cfg.vocab % sizes.get("model", 1) == 0:
        put("logits", shard.P(bdim, None, "model"))
    if cfg.moe is not None:
        # the batch-sharded MoE combine (the dispatch runs on local shards)
        put("moe_y", shard.P(bdim, None, None))


def _memory(counter: OpCounter, args, outputs) -> dict:
    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    arg_keys = {StorageWeakRef(local(t).untyped_storage()).cdata for t in _tensors(args)}
    outs = [local(t) for t in _tensors(outputs)]
    return {
        "argument_size_in_bytes": sum(_nbytes(local(t)) for t in _tensors(args)),
        "output_size_in_bytes": sum(
            _nbytes(t) for t in outs
            if StorageWeakRef(t.untyped_storage()).cdata not in arg_keys),
        "temp_size_in_bytes": counter.peak_bytes,
        "generated_code_size_in_bytes": 0,  # eager: nothing is compiled
    }


def lower_program(arch_spec, cfg, seq: int, batch: int, kind: str, mesh, *,
                  device: str = "cuda", microbatches: int = 1, last_only: bool = False,
                  constraints: dict | None = None):
    """Run one step of (cfg, seq, batch, kind) on `mesh` under a fresh
    OpCounter, with the activation constraints `_set_constraints` sets
    and then `constraints` ({name: (mesh, placements)}). Returns (metrics,
    memory, params_total, collective_calls)."""
    counter = OpCounter()
    with counter, _repeated_loops(counter), implicit_replication():
        params = init_params(cfg, device=device)
        params_total = sum(p.numel() for p in params.parameters())
        distribute_model(params, mesh)
        inputs = _make_inputs(arch_spec, cfg, seq, batch, kind, device)
        _set_constraints(cfg, mesh, seq, batch, kind)
        for name, pinned in (constraints or {}).items():
            L.set_constraint(name, pinned)
        try:
            if kind == "train":
                params.requires_grad_()
                tcfg = TrainConfig(adamw=AdamWConfig(moment_dtype=arch_spec.opt_dtype),
                                   microbatches=microbatches)
                state = init_state(tcfg.adamw, params)  # moments placed as the params
                batch_in = {k: place_batch(v, mesh) for k, v in inputs.items()}
                args = (list(params.parameters()), state, batch_in)
                step = make_train_step(cfg, tcfg)
                with counter.measuring(args):
                    _, _, out = step(params, state, batch_in)
            elif kind == "prefill":
                x = place_batch(inputs["inputs"], mesh)
                args = (list(params.parameters()), x)
                with counter.measuring(args), torch.no_grad():
                    out = apply_model(params, cfg, x, last_only=last_only)
            else:
                cache_len = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
                cache = init_cache(cfg, batch, cache_len, device=device)
                cache = tuple(tuple(distribute_tensor(leaf, *sh) for leaf, sh in zip(pos, shs))
                              for pos, shs in zip(cache, shard.cache_shardings(cache, mesh)))
                tok = place_batch(inputs["inputs"], mesh)
                args = (list(params.parameters()), tok, cache)
                with counter.measuring(args):
                    out = decode_step(params, cfg, tok, cache, seq - 1)
        finally:
            L.clear_constraints()
        metrics = {"flops": float(counter.flops), "bytes_accessed": float(counter.bytes),
                   "collective_bytes": dict(counter.collectives)}
        mem = _memory(counter, args, out)
    return metrics, mem, params_total, dict(counter.collective_calls)


def _make_inputs(arch_spec, cfg, seq, batch, kind, device) -> dict:
    s = 1 if kind == "decode" else seq

    def tokens():
        return torch.randint(0, cfg.vocab, (batch, s), dtype=torch.int32, device=device)

    x = (tokens() if arch_spec.modality == "text" else
         torch.randn((batch, s, cfg.d_model), dtype=torch.bfloat16, device=device))
    out = {"inputs": x}
    if kind == "train":
        out["labels"] = tokens()
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool, device_type: str = "cuda", *,
               mb8: bool = True) -> dict:
    """Trace one (arch, shape, mesh) cell at full width on the production
    mesh, in a fake world of its own; returns the record (the reference's
    keys). Without `mb8` a train cell skips its microbatches=8 trace
    (memory_mb8 is None)."""
    spec = get_arch(arch)
    if not spec.shape_supported(shape_name):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "why": spec.notes}
    shape, _axes = production_layout(multi_pod)
    return trace_cell(arch, spec.model, shape_name, SHAPES[shape_name], multi_pod, shape,
                      device_type, mb8=mb8)


def trace_cell(arch: str, cfg, shape_name: str, dims: tuple[int, int, str], multi_pod: bool,
               mesh_shape: tuple[int, ...], device_type: str, *, mb8: bool = True) -> dict:
    """lower_cell's record for `cfg` (the arch's full width or its reduced
    config) at dims = (seq, batch, kind), on a mesh of `mesh_shape` with
    the production mesh's axis names, in a fake world of its size."""
    spec = get_arch(arch)
    seq, batch, kind = dims
    axes = production_layout(multi_pod)[1]
    with fake_world(math.prod(mesh_shape)):
        mesh = init_device_mesh(device_type, mesh_shape, mesh_dim_names=axes)
        t0 = time.time()
        metrics, mem, params_total, _ = lower_program(spec, cfg, seq, batch, kind, mesh,
                                                      device=device_type)
        t_main = time.time() - t0
        mem_mb8 = None
        if kind == "train" and mb8:
            # production memory config: 8-way gradient accumulation (flops
            # accounting stays on the mb=1 step)
            _, mem_mb8, _, _ = lower_program(spec, cfg, seq, batch, kind, mesh,
                                             device=device_type, microbatches=8)
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "mesh": dict(zip(axes, mesh_shape)),
        "seconds_to_compile": round(t_main, 1),  # trace seconds: nothing is compiled
        "raw": metrics,
        "memory": mem,
        "memory_mb8": mem_mb8,
        "params_total": int(params_total),
        "repeats": cfg.repeats,
        "unit_layers": len(cfg.block_pattern),
        "flops": metrics["flops"],
        "bytes_accessed": metrics["bytes_accessed"],
        "collective_bytes": metrics["collective_bytes"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", help="device type of the fake tensors")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if not args.all and not (args.arch and args.shape):
        ap.error("--arch/--shape or --all")
    # --all: every arch and shape, or those of the one --arch / --shape given
    cells = [(a, s) for a in ([args.arch] if args.arch else ARCHS)
             for s in ([args.shape] if args.shape else SHAPES)]
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for arch, shape in cells:
        tag = f"{arch}_{shape}_{'pod2' if args.multi_pod else 'pod1'}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[cached  ] {tag}", flush=True)
            continue
        try:
            rec = lower_cell(arch, shape, args.multi_pod, args.device)
        except Exception as e:  # a dry-run failure is a bug: record loudly
            rec = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                   "status": "FAILED", "error": f"{type(e).__name__}: {e}"}
            failed += 1
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = (
            f"flops/dev={rec['flops']:.3e}"
            f" coll={sum(rec['collective_bytes'].values()):.3e}B"
            f" trace={rec['seconds_to_compile']}s"
            if status == "ok" else rec.get("why", rec.get("error", ""))
        )
        print(f"[{status:8s}] {tag:55s} {extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
