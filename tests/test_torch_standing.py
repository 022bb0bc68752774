"""The port's StandingQueryEngine against the reference engine, on the
same ingest sequence.

Each workload is built twice from the same numpy columns, and every
register / ingest / delete / refresh is applied to both engines: the port's
(`ExecOptions(device="cpu")`) and the reference's. After each step the two
must hold the same result (counts, or agg=None tuples) and the same stage
counters (`stage_runs`, `stages_skipped`, `stages_recomputed`), and the
result must equal the reference eager engine's over the live snapshot.
"""
import numpy as np

import repro.core as J
from repro.core import relcache as jrelcache
from repro.core.api import ExecOptions as JExecOptions
from repro.core.plan import BinaryPlan as JBinaryPlan
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro.serve import StandingQueryEngine as JStandingQueryEngine
from repro_torch.core import ExecOptions, relcache, to_sorted_tuples
from repro_torch.core.plan import BinaryPlan
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from repro_torch.serve import StandingQueryEngine

CHAIN4 = [("R", ("a", "b")), ("S", ("b", "c")), ("T", ("c", "d")), ("U", ("d", "e"))]
STAGE_COUNTERS = ("stage_runs", "stages_skipped", "stages_recomputed")


class Engines:
    """The port's engine and the reference's over two relation sets made
    from the same numpy columns; every operation is applied to both."""

    def __init__(self, rng, atoms=CHAIN4, n=200, dom=12):
        cols = {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in atoms}
        self.q = Query([Atom(a, vs) for a, vs in atoms])
        self.jq = JQuery([JAtom(a, vs) for a, vs in atoms])
        self.rels = {a: Relation(a, {v: c.copy() for v, c in cs.items()}) for a, cs in cols.items()}
        self.jrels = {a: JRelation(a, {v: c.copy() for v, c in cs.items()})
                      for a, cs in cols.items()}
        self.eng = StandingQueryEngine(options=ExecOptions(device="cpu"))
        self.jeng = JStandingQueryEngine(options=JExecOptions())
        self.pairs = []  # (port handle, reference handle, filters)

    def bushy(self):
        """(R⋈S) ⋈ (T⋈U) in both packages' plan classes."""
        a = {at.alias: at for at in self.q.atoms}
        ja = {at.alias: at for at in self.jq.atoms}
        return (BinaryPlan(BinaryPlan(a["R"], a["S"]), BinaryPlan(a["T"], a["U"])),
                JBinaryPlan(JBinaryPlan(ja["R"], ja["S"]), JBinaryPlan(ja["T"], ja["U"])))

    def register(self, agg="count", filters=None, trees=(None, None)):
        sq = self.eng.register(self.q, self.rels, filters, agg=agg, plan_tree=trees[0])
        jsq = self.jeng.register(self.jq, self.jrels, filters, agg=agg, plan_tree=trees[1])
        self.pairs.append((sq, jsq, filters))
        self.check()
        return sq

    def ingest(self, alias, delta):
        changed = self.eng.ingest(self.rels[alias], {v: c.copy() for v, c in delta.items()})
        jchanged = self.jeng.ingest(self.jrels[alias], {v: c.copy() for v, c in delta.items()})
        assert [s.qid for s in changed] == [s.qid for s in jchanged]
        self.check()
        return changed

    def delete(self, alias, rows):
        relcache.delete(self.rels[alias], rows)
        jrelcache.delete(self.jrels[alias], rows)

    def refresh(self):
        changed, jchanged = self.eng.refresh(), self.jeng.refresh()
        assert [s.qid for s in changed] == [s.qid for s in jchanged]
        self.check()
        return changed

    def counters(self):
        return {c: getattr(self.eng, c) for c in STAGE_COUNTERS}

    def oracle(self, agg, filters):
        live = {a: jrelcache.live_relation(r) for a, r in self.jrels.items()}
        for var, k in (filters or {}).items():
            for a, r in live.items():
                if var in r.columns:
                    keep = r.columns[var] == k
                    live[a] = JRelation(r.name, {v: c[keep] for v, c in r.columns.items()})
        return J.free_join(self.jq, live, agg=agg)

    def check(self):
        assert self.counters() == {c: getattr(self.jeng, c) for c in STAGE_COUNTERS}
        assert self.eng.degraded_refreshes == self.jeng.degraded_refreshes == 0
        for sq, jsq, filters in self.pairs:
            assert sq.result_version == jsq.result_version
            want = self.oracle(sq.template.agg, filters)
            if sq.template.agg == "count":
                assert sq.result == jsq.result == want
            else:
                tuples = to_sorted_tuples(sq.result, self.q.head)
                assert tuples == J.to_sorted_tuples(jsq.result, self.jq.head)
                assert tuples == J.to_sorted_tuples(want, self.jq.head)


def delta(rng, vars_, n, dom=12):
    return {v: rng.integers(0, dom, n).astype(np.int32) for v in vars_}


def test_standing_count_tracks_reference_across_ingest(rng):
    e = Engines(rng)
    sq = e.register()
    for _ in range(3):
        assert sq in e.ingest("U", delta(rng, ("d", "e"), 50))
    e.delete("R", np.arange(20))
    e.refresh()


def test_noop_refresh_skips_every_stage(rng):
    e = Engines(rng)
    sq = e.register()
    before = e.counters()
    assert e.refresh() == []
    after = e.counters()
    assert after["stages_recomputed"] == before["stages_recomputed"]
    assert after["stages_skipped"] == before["stages_skipped"] + len(sq.states)


def test_unchanged_stage_replays_cached_buffers(rng):
    """A forced bushy plan (R⋈S) ⋈ (T⋈U): an ingest into R leaves the
    T⋈U stage skipped, replaying its cached device buffers."""
    e = Engines(rng)
    sq = e.register(trees=e.bushy())
    nstages = len(sq.states)
    assert nstages >= 2
    before = e.counters()
    e.ingest("R", delta(rng, ("a", "b"), 40))
    skipped = e.counters()["stages_skipped"] - before["stages_skipped"]
    recomputed = e.counters()["stages_recomputed"] - before["stages_recomputed"]
    assert skipped >= 1, "the stage not reading R must replay its cached buffers"
    assert recomputed < nstages and recomputed + skipped == nstages


def test_materialized_standing_query(rng):
    e = Engines(rng, n=120)
    e.register(agg=None)
    e.ingest("T", delta(rng, ("c", "d"), 30))


def test_cotemplate_queries_share_runners(rng):
    e = Engines(rng, n=100)
    sq1 = e.register()
    sq2 = e.register()
    assert sq1.template.key == sq2.template.key
    assert len(e.eng._runners) == len(e.jeng._runners) == 1
    e.ingest("S", delta(rng, ("b", "c"), 40))


def test_filtered_standing_query(rng):
    """Two standing queries differing only in the filter constant share
    runners and each tracks its own filtered oracle."""
    e = Engines(rng, atoms=[("R", ("a", "b")), ("S", ("b", "c"))], n=150, dom=6)
    for k in (1, 3):
        e.register(filters={"a": k})
    assert len(e.eng._runners) == len(e.jeng._runners) == 1
    e.ingest("R", delta(rng, ("a", "b"), 60, dom=6))
