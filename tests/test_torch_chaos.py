"""Fault injection against the port's serving stack, beside the reference.

The reference's chaos cases (tests/test_chaos.py) run in both packages on
the same seeded data, with the same fault armed in each package's own
`faults` module: every admitted request is answered (possibly degraded,
never crashed) and equals the eager oracle, and the two packages agree on
each request's rung (`degraded_to`), its error, and the engine's and the
admission controller's counters. The port runs with
`ExecOptions(device="cpu")`; its eager rung runs on that same device.

The port's own rule is tested here too: the ladder absorbs only what
`faults.recoverable` names (injected faults, MemoryBudgetError,
torch.OutOfMemoryError). A kernel build error or a CUDA launch error
raised inside a kernel wrapper propagates out of `JoinServeEngine.step()`,
`compiled_free_join` and `StandingQueryEngine.refresh()`, and is never
answered eagerly.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import faults
from repro_torch.core.capacity import CapacityQuotaError
from repro_torch.core.membudget import MemoryBudgetError
from repro_torch.kernels import csr_expand, hash_probe
from tests.test_torch_serving import PORT, TRIANGLE, assert_same, record, workload


def _triangle(P, seed=0, n=400, dom=8):
    return workload(P, TRIANGLE, seed=seed, n=n, dom=dom)


def _fast(eng):
    eng.backoff_base_ms = 0.0  # keep chaos rounds instant
    return eng


def _oracle(P, q, rels, c):
    return P.free_join(q, rels, agg="count", filters={"x": c})


def _serve(P, consts, kind=None, *, seed, slots=2, tenants=None, admission=None, **kw):
    """Submit one triangle request per constant, drain the engine with one
    fault armed, check every admitted answer against the oracle and
    return what both packages must agree on."""
    q, rels = _triangle(P, seed=seed)
    eng = _fast(P.engine(slots=slots, admission=admission))
    tenants = tenants or ["default"] * len(consts)
    with P.faults.inject(kind, **kw) as f:
        reqs = [eng.submit(q, rels, {"x": c}, tenant=t) for c, t in zip(consts, tenants)]
        eng.run()
    for req, c in zip(reqs, consts):
        assert req.done
        if req.error is None:
            assert req.result == _oracle(P, q, rels, c)
    return record(P, q, reqs, eng), f.fired


# ---- the degradation ladder --------------------------------------------


def compile_fail_halved(P):
    rec, fired = _serve(P, (2, 5), "compile_fail", seed=0, times=1)
    assert fired == 1 and {r[-1] for r in rec["requests"]} == {"halved"}
    return rec, fired


def compile_fail_to_eager(P):
    """Three build failures exhaust the full-width, halved and unbatched
    rungs; the eager rung answers."""
    rec, fired = _serve(P, (1, 4), "compile_fail", seed=1, times=3)
    assert fired == 3 and {r[-1] for r in rec["requests"]} == {"eager"}
    return rec, fired


def device_oom(P):
    rec, fired = _serve(P, (3, 6), "device_oom", seed=2, times=1)
    assert all(r[-1] is not None and r[2] is None for r in rec["requests"])
    return rec, fired


def eviction_storm(P):
    """Three over-quota lanes from one tenant: each eviction is charged to
    the offender; the compliant co-batched tenant is served on the fast
    path."""
    adm = P.AdmissionController(default=P.QueryQuota(max_retries=5))
    rec, fired = _serve(P, (0, 1, 2, 5), "overflow_storm", seed=4, slots=4, admission=adm,
                        tenants=["evil"] * 3 + ["good"], times=3, lanes=(0, 0, 0))
    assert rec["admission"]["rejected_by"] == {"evil": 3}
    assert rec["requests"][-1][2:] == (None, None, None)
    return rec, fired


def retry_budget(P):
    adm = P.AdmissionController(default=P.QueryQuota(),
                                per_tenant={"evil": P.QueryQuota(max_retries=1)})
    rec, fired = _serve(P, (0, 1, 2, 5), "overflow_storm", seed=5, slots=4, admission=adm,
                        tenants=["evil"] * 3 + ["good"], times=2, lanes=(0, 0))
    assert rec["admission"]["rejected_by"] == {"evil": 3}
    assert [r[3] for r in rec["requests"]].count("retries") == 1
    return rec, fired


def slow_dispatch_deadline(P):
    q, rels = _triangle(P, seed=6)
    eng = _fast(P.engine(slots=1))
    r1 = eng.submit(q, rels, {"x": 2})
    r2 = eng.submit(q, rels, {"x": 4}, deadline_ms=30.0)
    with P.faults.inject("slow_dispatch", times=1, delay_s=0.2) as f:
        eng.run()
    assert r1.result == _oracle(P, q, rels, 2)
    assert getattr(r2.error, "reason", None) == "deadline"
    return record(P, q, [r1, r2], eng), f.fired


def generous_deadline(P):
    q, rels = _triangle(P, seed=7)
    eng = _fast(P.engine(slots=2))
    req = eng.submit(q, rels, {"x": 3}, deadline_ms=60_000.0)
    eng.run()
    assert req.result == _oracle(P, q, rels, 3)
    return record(P, q, [req], eng)


def mixed_barrage(P):
    q, rels = _triangle(P, seed=40)
    eng = _fast(P.engine(slots=2))
    consts = [1, 2, 3, 4, 5, 6]
    with P.faults.inject("compile_fail", times=1), P.faults.inject(
        "device_oom", times=1
    ), P.faults.inject("slow_dispatch", times=1, delay_s=0.001):
        reqs = [eng.submit(q, rels, {"x": c}, tenant=f"t{i % 3}")
                for i, c in enumerate(consts)]
        eng.run()
    assert [r.result for r in reqs] == [_oracle(P, q, rels, c) for c in consts]
    assert eng.faults_absorbed >= 1 and sum(eng.degraded.values()) >= 1
    return record(P, q, reqs, eng)


# ---- out-of-band mutation and standing queries -------------------------


def mutation_skew(P):
    q, rels = _triangle(P, seed=8, n=200)
    r = rels["R"]
    P.relcache.append(r, {v: np.asarray([1], r.columns[v].dtype) for v in r.schema})
    before = P.relcache.oob_swaps()
    P.relcache.reset_oob_warning()
    with P.faults.inject("mutation_skew", rel=r), pytest.warns(
        RuntimeWarning, match="out-of-band column swap"
    ):
        got = P.compiled_free_join(q, rels, agg="count")
    live = {a: P.relcache.live_relation(x) for a, x in rels.items()}
    assert got == P.free_join(q, live, agg="count")
    P.relcache.append(r, {v: np.asarray([2], r.columns[v].dtype) for v in r.schema})
    with P.faults.inject("mutation_skew", rel=r), warnings.catch_warnings():
        warnings.simplefilter("error")
        again = P.compiled_free_join(q, rels, agg="count")
    return got, again, P.relcache.oob_swaps() - before


def standing_recovers(P):
    """A device fault mid-refresh answers from the eager engine (result
    still right, degraded_to set); the next clean refresh rebuilds the
    compiled pipeline and clears the flag."""
    q, rels = _triangle(P, seed=9, n=300)
    eng = P.standing()
    sq = eng.register(q, rels, {"x": 3})

    def want():
        live = {a: P.relcache.live_relation(r) for a, r in rels.items()}
        return P.free_join(q, live, agg="count", filters={"x": 3})

    states = [(sq.result == want(), sq.degraded_to)]
    delta = {v: np.random.default_rng(99).integers(0, 8, 40) for v in rels["R"].schema}
    with P.faults.inject("device_oom", times=1) as f:
        P.relcache.append(rels["R"], delta)
        eng.refresh()
    states.append((sq.result == want(), sq.degraded_to, eng.degraded_refreshes, f.fired))
    v_deg = sq.result_version
    eng.refresh()
    states.append((sq.result == want(), sq.degraded_to, sq.result_version > v_deg))
    assert all(s[0] for s in states)
    return states, sq.result


# ---- the memory governor under live load -------------------------------


def governed_bytes_under_budget(P):
    gov = P.membudget.GOVERNOR
    gov.reset()
    q, rels0 = _triangle(P, seed=20, n=800)
    assert P.compiled_free_join(q, rels0, agg="count") == P.free_join(q, rels0, agg="count")
    baseline = gov.live_bytes
    assert baseline > 0, "the compiled path must report its buffers"
    cap = int(baseline * 1.5)
    ev0 = gov.evictions
    with P.membudget.budget(cap):
        assert gov.live_bytes <= cap
        for seed in (21, 22, 23, 24):
            qq, rr = _triangle(P, seed=seed, n=800)
            assert P.compiled_free_join(qq, rr, agg="count") == P.free_join(qq, rr, agg="count")
            assert gov.live_bytes <= cap, f"budget breached on seed {seed}"
    assert gov.evictions > ev0, "making room must have evicted cold entries"
    return baseline, gov.evictions - ev0


def oversized_workload_sheds(P):
    gov = P.membudget.GOVERNOR
    gov.reset()
    q, rels = _triangle(P, seed=30, n=600)
    sheds0 = gov.sheds
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the degradation notice
        with P.membudget.budget(64):
            got = P.compiled_free_join(q, rels, agg="count")
            assert got == P.free_join(q, rels, agg="count")
            assert gov.live_bytes <= 64
    assert gov.sheds > sheds0
    return got


CHAOS = [compile_fail_halved, compile_fail_to_eager, device_oom, eviction_storm, retry_budget,
         slow_dispatch_deadline, generous_deadline, mixed_barrage, mutation_skew,
         standing_recovers, governed_bytes_under_budget, oversized_workload_sheds]


@pytest.mark.parametrize("scenario", CHAOS, ids=lambda f: f.__name__)
def test_chaos_matches_reference(scenario):
    assert_same(scenario)


# ---- what the ladder may absorb ------------------------------------------


@pytest.mark.parametrize("exc,absorbed", [
    (faults.InjectedCompileError("x"), True),
    (faults.InjectedOOMError("x"), True),
    (MemoryBudgetError(10, 0, 5), True),
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), False),
    (RuntimeError("kernel build failed: hash_probe: nvcc exited with 1"), False),
    (FileNotFoundError("nvcc not found on PATH or under CUDA_HOME"), False),
    (RuntimeError("hash_probe launch failed: unspecified launch failure"), False),
    (RuntimeError("CUDA out of memory"), False),  # the text alone is not the allocator's error
    (CapacityQuotaError(0, 0, 10, 5), False),
    (ValueError("nope"), False),
])
def test_recoverable_names_exactly_three_things(exc, absorbed):
    assert faults.recoverable(exc) is absorbed


def test_inject_rejects_unknown_kinds_and_arms_nothing_after():
    with pytest.raises(ValueError, match="unknown fault kind"):
        with faults.inject("cosmic_ray"):
            pass
    with pytest.raises(ValueError, match="rel="):
        with faults.inject("mutation_skew"):
            pass
    with faults.inject("device_oom") as f:
        pass
    assert f.fired == 0 and not faults._ACTIVE
    faults.fire("dispatch")  # nothing armed: a no-op


def test_unrecoverable_dispatch_error_propagates():
    q, rels = _triangle(PORT, seed=3)
    eng = _fast(PORT.engine(slots=2))
    eng.submit(q, rels, {"x": 2})

    def boom(*a, **k):
        raise ValueError("genuine bug")

    eng._dispatch_batched = boom
    with pytest.raises(ValueError, match="genuine bug"):
        eng.step()


LAUNCH_ERROR = "CUDA error: an illegal memory access was encountered"


@pytest.fixture(params=["hash_probe", "csr_expand"])
def broken_kernel(request, monkeypatch):
    """A kernel wrapper whose kernel fails the way a CUDA launch does (its
    plain version, which the CPU runs, is replaced)."""
    mod = {"hash_probe": hash_probe, "csr_expand": csr_expand}[request.param]

    def fail(*a, **k):
        raise RuntimeError(LAUNCH_ERROR)

    return lambda: monkeypatch.setattr(mod, f"{request.param}_plain", fail)


def test_kernel_error_propagates_out_of_every_surface(broken_kernel):
    q, rels = _triangle(PORT, seed=11)
    eng = _fast(PORT.engine(slots=2))
    st = PORT.standing()
    sq = st.register(q, rels, {"x": 3})
    PORT.compiled_free_join(q, rels, agg="count")  # warm: tries cached, runner built
    broken_kernel()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # a degradation would warn
        with pytest.raises(RuntimeError, match="illegal memory access"):
            PORT.compiled_free_join(q, rels, agg="count")
        reqs = [eng.submit(q, rels, {"x": c}) for c in (1, 2)]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            eng.step()
        PORT.relcache.append(rels["R"], {"x": np.asarray([3]), "y": np.asarray([1])})
        with pytest.raises(RuntimeError, match="illegal memory access"):
            st.refresh()
    assert not any(r.done for r in reqs)
    assert eng.faults_absorbed == 0 and sum(eng.degraded.values()) == 0 and eng.served == 0
    assert st.degraded_refreshes == 0 and sq.degraded_to is None


def test_compiled_free_join_ladder_reports_the_rung():
    q, rels = _triangle(PORT, seed=12)
    want = _oracle(PORT, q, rels, 4)
    info = {}
    with faults.inject("device_oom", times=1), pytest.warns(RuntimeWarning, match="degraded"):
        got = PORT.compiled_free_join(q, rels, agg="count", filters={"x": 4}, info=info)
    assert got == want
    assert info["degraded_to"] == "eager" and "InjectedOOMError" in info["degraded_from"]
    info = {}
    assert PORT.compiled_free_join(q, rels, agg="count", filters={"x": 4}, info=info) == want
    assert "degraded_to" not in info


def test_fault_scenario_main_recovers():
    assert faults.main(["--device", "cpu"]) == 0
