"""The port's launch layer (repro_torch.launch: mesh, sharding, dryrun,
dryrun_join, roofline, perf) against the reference's, on the CPU.

Sharding rules are compared leaf for leaf over all ten architectures at
full width (shapes from jax.eval_shape and from the port's init_params
under FakeTensorMode, nothing allocated) on stub meshes; placements,
per-rank counts and the dry-runs run in torch's "fake" process group,
one process standing in for 8 to 512 ranks, torn down after each test.
The LM dry-run runs reduced configs on small meshes; the join dry-run's
count is held to the reference's make_count_fn(impl="jnp") on the same
columns."""
import ast
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode

from repro import configs as r_configs
from repro.core import binary2fj as r_binary2fj
from repro.core import factor as r_factor
from repro.core.compiled import make_count_fn as r_make_count_fn
from repro.launch import roofline as r_roofline
from repro.launch import sharding as r_shard
from repro.models import transformer as r_tf
from repro.relational.schema import clover_query as r_clover
from repro.relational.schema import triangle_query as r_triangle
from repro_torch import configs as p_configs
from repro_torch.launch import dryrun, dryrun_join, perf, roofline
from repro_torch.launch import sharding as p_shard
from repro_torch.launch.mesh import dp_axes, fake_world, make_production_mesh
from repro_torch.models import layers, transformer as p_tf

ARCHS = sorted(r_configs.ARCHS)
ROOT = Path(__file__).resolve().parents[1]


class StubMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


class StubMeshPod:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


STUBS = [StubMesh(), StubMeshPod()]


@pytest.fixture
def world():
    """A fake world of n ranks, torn down after the test (other files run
    later in the same worker)."""
    stack = []

    def open_world(n: int):
        ctx = fake_world(n)
        ctx.__enter__()
        stack.append(ctx)

    yield open_world
    while stack:
        stack.pop().__exit__(None, None, None)
    assert not dist.is_initialized()


def reduced(arch: str):
    return dataclasses.replace(p_configs.get_arch(arch).reduced)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_reference_every_leaf(arch):
    """Each per-layer leaf's spec is the reference's spec of its stacked
    (R, ...) leaf with the leading None dropped; the others are equal."""
    rcfg, pcfg = r_configs.get_arch(arch).model, p_configs.get_arch(arch).model
    shapes = jax.eval_shape(lambda k: r_tf.init_params(k, rcfg), jax.random.PRNGKey(0))
    ref = {jax.tree_util.keystr(path): leaf.shape
           for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with FakeTensorMode():
        model = p_tf.init_params(pcfg, device="cpu")
    unit = len(pcfg.block_pattern)
    seen = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        stacked = parts[0] == "blocks"
        if stacked:
            key = f"['blocks'][{int(parts[1]) % unit}]" + "".join(f"['{k}']" for k in parts[2:])
        else:
            key = "".join(f"['{k}']" for k in parts)
        want_shape = ref[key]
        assert tuple(want_shape) == ((pcfg.repeats,) if stacked else ()) + tuple(p.shape), name
        for mesh in STUBS:
            want = tuple(r_shard.param_spec(key, want_shape, mesh))
            want = want[1:] if stacked else want
            got = tuple(p_shard.param_spec(name, tuple(p.shape), mesh))
            assert got == want, (arch, name, type(mesh).__name__, got, want)
        seen += 1
    assert seen == len(ref) - sum(1 for k in ref if k.startswith("['blocks']")) + sum(
        pcfg.repeats for k in ref if k.startswith("['blocks']"))


def test_param_spec_reference_cases():
    """The reference's own cases (tests/test_launch.py), each block leaf
    without its leading repeats dim and its spec without the leading None."""
    m = StubMesh()
    P = p_shard.P
    # attention: heads divisible -> heads sharded
    assert p_shard.param_spec("blocks.0.mixer.wq", (6144, 48, 128), m) == P("data", "model", None)
    # heads NOT divisible -> replicate over model (never head_dim)
    assert p_shard.param_spec("blocks.0.mixer.wk", (6144, 8, 128), m) == P("data", None, None)
    # MoE: E divisible -> expert parallel
    assert p_shard.param_spec("blocks.0.ffn.wi", (128, 7168, 4864), m)[0] == "model"
    # MoE: E not divisible -> ffn-dim TP + FSDP on the other dim
    assert p_shard.param_spec("blocks.0.ffn.wi", (8, 6144, 16384), m) == P(None, "data", "model")
    # embeddings vocab-parallel
    assert p_shard.param_spec("embed.table", (151936, 1536), m) == P("model", "data")
    # 1D norm scales: generic rule shards the (divisible) dim over model
    assert p_shard.param_spec("final_norm.scale", (1536,), m) == P("model")
    # the reference's bracketed paths normalize to the same names
    assert p_shard.param_spec("['embed']['table']", (151936, 1536), m) == P("model", "data")


def _cache_shapes(arch: str, shape: str):
    cfg = p_configs.get_arch(arch).model
    seq, batch, _kind = p_configs.SHAPES[shape]
    with FakeTensorMode():
        cache = p_tf.init_cache(cfg, batch, seq, device="cpu")
    return [tuple(leaf.shape) for pos in cache for leaf in pos]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    spec = p_configs.get_arch(arch)
    for shape, (seq, batch, kind) in p_configs.SHAPES.items():
        ins = spec.input_specs(shape)
        shapes = [tuple(v.shape) for v in ins.values() if v.ndim]
        shapes.append((batch, 1 if kind == "decode" else seq, spec.model.d_model))
        if kind == "decode" and spec.shape_supported(shape):
            caches = _cache_shapes(arch, shape)
            r_cfg = r_configs.get_arch(arch).model
            r_cache = jax.eval_shape(lambda: r_tf.init_cache(r_cfg, batch, seq))
            assert caches == [tuple(x.shape) for x in jax.tree.leaves(r_cache)]
        else:
            caches = []
        for mesh in STUBS:
            for s in shapes:
                assert tuple(p_shard.batch_spec(s, mesh)) == tuple(r_shard.batch_spec(s, mesh)), s
            for s in caches:
                assert tuple(p_shard.cache_spec(s, mesh)) == tuple(r_shard.cache_spec(s, mesh)), s


def test_reference_batch_and_cache_cases():
    m = StubMesh()
    assert p_shard.batch_spec((256, 4096), m) == p_shard.P("data", None)
    assert p_shard.batch_spec((1, 524288), m) == p_shard.P(None, "data")
    s = p_shard.cache_spec((28, 128, 32768, 2, 128), m)
    assert s[1] == "data" and "model" in s


# ---------------------------------------------------------------------------
# the fake world, placements, per-rank counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fake_world_and_production_mesh(world, multi_pod):
    n = 512 if multi_pod else 256
    world(n)
    assert dist.get_world_size() == n and dist.get_rank() == 0
    assert dist.get_backend() == "fake"
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))
    assert dp_axes(mesh) == (("pod", "data") if multi_pod else ("data",))
    # FakeStore's world: one sharded product gathers once, and nothing moves
    with FakeTensorMode():
        x = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0)] + [Replicate()] * (mesh.ndim - 1))
        with CommDebugMode() as comm:
            x.redistribute(mesh, [Replicate()] * mesh.ndim)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert counts == {"c10d_functional.all_gather_into_tensor": 1}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_placements_give_local_shapes(world, multi_pod):
    world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    dp = ("pod", "data") if multi_pod else "data"
    cases = [
        (p_shard.P(dp, "model", None), (512, 64, 32)),
        (p_shard.P("model", "data"), (151936 // 4 * 4 // 16 * 16, 1536)),
        (p_shard.P(None, "data", "model"), (8, 6144, 16384)),
        (p_shard.P("model"), (1536,)),
        (p_shard.batch_spec((256, 4096), mesh), (256, 4096)),
        (p_shard.cache_spec((28, 128, 32768, 2, 128), mesh), (28, 128, 32768, 2, 128)),
    ]
    for spec, shape in cases:
        want = []
        for d, n in enumerate(shape):
            e = spec[d] if d < len(spec) else None
            names = () if e is None else (e,) if isinstance(e, str) else e
            want.append(n // math.prod(sizes[a] for a in names))
        pl = p_shard.placements(spec, mesh)
        assert len(pl) == mesh.ndim
        with FakeTensorMode():
            local = distribute_tensor(torch.empty(shape), mesh, pl).to_local()
        assert tuple(local.shape) == tuple(want), (spec, shape)
    # a tuple dim is sharded on both mesh dims, pod outer
    if multi_pod:
        assert p_shard.placements(p_shard.P(("pod", "data"), "model"), mesh) == (
            Shard(0), Shard(0), Shard(1))


def test_param_shardings_cover_every_leaf(world):
    world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        model = p_tf.init_params(reduced("mixtral-8x22b"), device="cpu")
    specs = p_shard.param_shardings(model, mesh)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert specs[name] == (mesh, p_shard.placements(
            p_shard.param_spec(name, tuple(p.shape), mesh), mesh))
    with FakeTensorMode():
        cache = p_tf.init_cache(reduced("mixtral-8x22b"), 8, 16, device="cpu")
    shs = p_shard.cache_shardings(cache, mesh)
    assert [len(pos) for pos in shs] == [len(pos) for pos in cache]


def test_counter_counts_local_flops_and_collective_bytes(world):
    """Hand-counted per-rank answers on a synthetic sharded program; the
    collective bytes are the reference's HLO test's (all-gather 8x128
    bf16, all-reduce 64 f32)."""
    world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    counter = dryrun.OpCounter()
    with counter:
        a = distribute_tensor(torch.randn(64, 128), mesh, [Shard(0), Replicate()])
        b = distribute_tensor(torch.randn(128, 256), mesh, [Replicate(), Shard(1)])
        g = distribute_tensor(torch.randn(16, 128, dtype=torch.bfloat16), mesh,
                              [Replicate(), Shard(0)])
        part = DTensor.from_local(torch.randn(64), mesh, [Replicate(), Partial()],
                                  run_check=False)
        with counter.measuring((a, b, g, part)):
            c = a @ b
            g.redistribute(mesh, [Replicate(), Replicate()])
            part.redistribute(mesh, [Replicate(), Replicate()])
    # local (32, 128) @ (128, 64): 2 m n k
    assert counter.flops == 2 * 32 * 128 * 64
    assert tuple(c.to_local().shape) == (32, 64)
    # the result of gathering (4, 128) bf16 shards over a model dim of 4 is
    # (16, 128): 4,096 bytes; the all-reduce's result is (64,) fp32
    assert counter.collectives == {"all-gather": 16 * 128 * 2, "all-reduce": 64 * 4}
    # local bytes of the product: inputs and output, each once
    assert counter.bytes >= (32 * 128 + 128 * 64 + 32 * 64) * 4


def test_counter_matches_reference_hlo_bytes(world):
    world(2)
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    counter = dryrun.OpCounter()
    with counter:
        g = distribute_tensor(torch.randn(8, 128, dtype=torch.bfloat16), mesh, [Shard(0)])
        part = DTensor.from_local(torch.randn(64), mesh, [Partial()], run_check=False)
        with counter.measuring((g, part)):
            g.redistribute(mesh, [Replicate()])
            part.redistribute(mesh, [Replicate()])
    assert counter.collectives == {"all-gather": 8 * 128 * 2, "all-reduce": 64 * 4}
    assert counter.collective_calls == {"all-gather": 1, "all-reduce": 1}


# ---------------------------------------------------------------------------
# the models on DTensors
# ---------------------------------------------------------------------------


def test_embedding_equals_indexing_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    table = torch.randn(300, 48, generator=g)
    tokens = torch.randint(0, 300, (4, 17), generator=g, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        got = layers.embed_apply({"table": table}, tokens, dt)
        assert torch.equal(got, table[tokens].to(dt))


def test_lower_cell_skips_ineligible_cells():
    rec = dryrun.lower_cell("qwen2-1.5b", "long_500k", False, "cpu")
    assert rec["status"] == "skipped" and rec["why"]


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_repeated_loop_counts_equal_the_full_loop(arch, kind):
    """The rwkv6 time loop and mamba's chunk loop, traced as one step
    counted s (or chunks) times, give the full loop's flops and
    collective bytes."""
    import contextlib

    cfg = reduced(arch)
    if len(cfg.block_pattern) > 1:
        cfg = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern), moe=None)
    dims = (32 if arch.startswith("rwkv") else 512, 8, kind)
    got = dryrun.trace_cell(arch, cfg, "train_4k", dims, False, (2, 4), "cpu", mb8=False)
    real = dryrun._repeated_loops
    dryrun._repeated_loops = lambda counter: contextlib.nullcontext()
    try:
        want = dryrun.trace_cell(arch, cfg, "train_4k", dims, False, (2, 4), "cpu", mb8=False)
    finally:
        dryrun._repeated_loops = real
    assert got["flops"] == want["flops"]
    assert got["collective_bytes"] == want["collective_bytes"]
    # autograd's sums of the per-step gradients of the sliced inputs, and
    # the reads of a concatenation of chunks, are counted once, not a step
    assert 0.7 * want["bytes_accessed"] <= got["bytes_accessed"] <= want["bytes_accessed"]


# ---------------------------------------------------------------------------
# roofline, perf, the join dry-run
# ---------------------------------------------------------------------------


def _synthetic(arch, shape, multi_pod=False, **kw):
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "ok",
           "mesh": {"data": 16, "model": 16}, "flops": 3.1e14, "bytes_accessed": 7.7e12,
           "collective_bytes": {"all-gather": 4.0e11, "all-reduce": 1.2e10},
           "memory": {"argument_size_in_bytes": 1, "temp_size_in_bytes": 2.5e10},
           "memory_mb8": None, "params_total": 1}
    rec.update(kw)
    return rec


def test_analyse_matches_reference_with_h100_constants(monkeypatch):
    monkeypatch.setattr(r_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(r_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(r_roofline, "LINK_BW", roofline.LINK_BW)
    recs = [_synthetic("qwen2-1.5b", "train_4k"),
            _synthetic("mixtral-8x22b", "decode_32k", flops=1.0e9, bytes_accessed=9e12),
            _synthetic("gemma-2b", "prefill_32k", collective_bytes={"all-to-all": 9e13},
                       memory_mb8={"temp_size_in_bytes": 3e9}),
            _synthetic("rwkv6-1.6b", "long_500k", status="skipped"),
            _synthetic("qwen3-1.7b", "train_4k", flops=0.0)]
    for rec in recs:
        got, want = roofline.analyse(rec), r_roofline.analyse(rec)
        if want is None:
            assert got is None
            continue
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_roofline_main_reads_records(tmp_path, capsys):
    import json

    for i, rec in enumerate([_synthetic("qwen2-1.5b", "train_4k"),
                             _synthetic("qwen2-1.5b", "long_500k", status="skipped", why="n/a"),
                             {"arch": "gemma-2b", "shape": "train_4k", "multi_pod": False,
                              "status": "FAILED", "error": "boom"}]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    assert len(roofline.load(str(tmp_path))) == 3
    assert roofline.load(str(tmp_path), multi_pod=True) == []
    assert roofline.main(["--dir", str(tmp_path), "--csv", str(tmp_path / "t.csv")]) == 0
    out = capsys.readouterr().out
    assert "qwen2-1.5b" in out and "FAILED" in out and "N/A" in out
    assert (tmp_path / "t.csv").exists()


def _reference_parse_spec():
    """The reference's perf._parse_spec, read from its source: importing
    repro.launch.perf would set the host device count for this process's
    jax."""
    src = (ROOT / "src/repro/launch/perf.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef) and n.name == "_parse_spec")
    ns = {"P": jax.sharding.PartitionSpec}
    exec(compile(ast.Module([fn], []), "perf.py", "exec"), ns)
    return ns["_parse_spec"]


@pytest.mark.parametrize("s", ["dp,,model,", "dp", "", ",", "model", "dp,,,", "data,model",
                               ",dp,model"])
def test_parse_spec_matches_reference(s):
    got = tuple(perf._parse_spec(s))
    want = tuple(_reference_parse_spec()(s))
    assert got == want


def test_perf_measure_reduced():
    rec = perf.measure_config("mixtral-8x22b", reduced("mixtral-8x22b"), "prefill_32k",
                              (16, 8, "prefill"), {"moe_y": "dp,,", "q_chunk": 8}, (2, 4), "cpu")
    assert not dist.is_initialized()
    assert rec["flops_raw"] > 0 and rec["collective_total"] == sum(
        rec["collective_bytes"].values())
    assert rec["collective_s"] == rec["collective_total"] / roofline.LINK_BW
    with pytest.raises(NotImplementedError):
        perf.measure("qwen2-1.5b", "decode_32k", {}, "cpu")


@pytest.mark.parametrize("lever", ["moe_buf", "moe_out"])
def test_perf_rejects_levers_on_local_buffers(lever):
    """The dispatch and expert-output buffers never are DTensors, so a
    lever pinning them raises instead of logging a run that changed
    nothing."""
    with pytest.raises(ValueError, match=lever):
        perf.measure_config("mixtral-8x22b", reduced("mixtral-8x22b"), "prefill_32k",
                            (16, 8, "prefill"), {lever: "dp,,,"}, (2, 4), "cpu")
    assert not dist.is_initialized()


def test_lower_join_matches_reference_count():
    """Rank 0's count and overflow flag in a fake world of 8 equal the
    reference's make_count_fn(impl="jnp") on the same columns, with two
    all-reduces per query (count and flag)."""
    rows, cap, domain = 2000, 1 << 14, 1024
    recs = dryrun_join.count_world(8, False, rows, cap, "cpu", 0, warm=1, domain=domain)
    assert not dist.is_initialized()
    assert [r["shards"] for r in recs] == [8, 8]
    for rec, q in zip(recs, (r_triangle(), r_clover())):
        fj = r_factor(r_binary2fj(q.atoms, q))
        cols = {a: {v: jnp.asarray(c) for v, c in vs.items()}
                for a, vs in dryrun_join.fragment(q, rows, 0, domain).items()}
        count, ovf = r_make_count_fn(fj, [cap] * 4, impl="jnp")(cols)
        assert rec["query"] == str(q)
        assert (rec["count"], rec["overflow"]) == (int(count), int(bool(ovf)))
        assert rec["collectives"] == {"c10d.allreduce_": 2}
        assert rec["collective_bytes"] == {"all-reduce": 12}
        assert all(rec["launches"][k] > 0 for k in ("hash_probe", "csr_expand", "radix_rank"))
    assert recs[0]["count"] > 0 and recs[1]["count"] > 0


def test_dryrun_main_records_every_cell_and_fails_loudly(tmp_path, monkeypatch, capsys):
    """`--all` over one arch writes a record a shape; a cell that raises is
    recorded FAILED with its error and the run exits 1."""
    import json

    def fake_cell(arch, shape, multi_pod, device_type="cuda", *, mb8=True):
        if shape == "prefill_32k":
            raise RuntimeError("no rule")
        if not p_configs.get_arch(arch).shape_supported(shape):
            return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "skipped",
                    "why": "n/a"}
        return _synthetic(arch, shape, multi_pod, seconds_to_compile=0.1)

    monkeypatch.setattr(dryrun, "lower_cell", fake_cell)
    rc = dryrun.main(["--all", "--arch", "qwen2-1.5b", "--multi-pod", "--out", str(tmp_path)])
    assert rc == 1
    recs = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"qwen2-1.5b_{s}_pod2" for s in p_configs.SHAPES}
    assert recs["qwen2-1.5b_prefill_32k_pod2"] == {
        "arch": "qwen2-1.5b", "shape": "prefill_32k", "multi_pod": True, "status": "FAILED",
        "error": "RuntimeError: no rule"}
    assert recs["qwen2-1.5b_long_500k_pod2"]["status"] == "skipped"
    assert "[FAILED  ]" in capsys.readouterr().out
    # --skip-existing leaves written records alone
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k", "--multi-pod",
                        "--skip-existing", "--out", str(tmp_path)]) == 0
