"""CI gate: lint + audit every corpus case through the production stack.

For each corpus case this builds the runner via the same acquisition
path compiled_free_join uses, on `--device` (the card by default), lints
its freshly planned stage chain and capacity plan (+ template idempotence
for filtered cases), runs it once so overflow growth settles, then records
one more warm call and audits it (launch_audit: host syncs, K1 launches
and tensor ops per schedule op, uploads, trie builds, new executors).

Any ERROR-severity diagnostic fails the process (exit 1). Warnings and
info are printed but do not fail — the severity contract of README.md.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis [--seed N] [-v] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.corpus import build_runner, corpus_cases
from repro_torch.analysis.diagnostics import Report, Severity
from repro_torch.analysis.launch_audit import (
    audit_runner,
    runner_limits,
    schedule_ops,
    trace_runner,
)
from repro_torch.analysis.planlint import lint_chain, lint_template


def check_case(case, *, device: str = "cuda", verbose: bool = False) -> Report:
    runner, rels = build_runner(case, device=device)
    rep = Report()
    # lint FIRST, on fresh planner output: the capacity-vs-AGM check is a
    # planner-regression check, and overflow growth (below) legitimately
    # raises capacities past the planned AGM record when measured needs do
    chain = runner._as_chain(runner.cap_plan)
    rep.extend(
        lint_chain(
            runner.stages,
            chain,
            filter_vars=runner.filter_vars,
            batch=runner.batch,
        )
    )
    # then run once: overflow growth settles, so the audited call is the
    # one a warm serving stream would actually dispatch
    runner.run_relations(rels, filter_consts=case.filter_consts)
    if case.filters:
        from repro_torch.serve.templates import canonicalize

        template, _consts = canonicalize(
            case.query, case.relations, case.filters, options=case.options
        )
        rep.extend(lint_template(template))
    trace = trace_runner(runner, rels, filter_consts=case.filter_consts)
    rep.extend(audit_runner(runner, rels, name=f"{case.name}.call", trace=trace))
    if verbose:
        limits = runner_limits(runner)
        n_ops = sum(trace.ops.values()) + sum(trace.kernel_calls.values())
        print(f"  runner: {len(runner.stages)} stage(s), {runner.compiles} compile(s), "
              f"{runner.retries} retr(ies); warm call: {trace.syncs} sync(s) ("
              f"{limits['read_backs']} read-backs), kernel calls {trace.kernel_calls}, {n_ops} ops (limit "
              f"{limits['ops']}), {n_ops / schedule_ops(runner):.1f} per schedule op")
    return rep


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan verifier + launch auditor over the corpus",
    )
    ap.add_argument("--seed", type=int, default=0, help="corpus data seed")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the runners run (default: the card)")
    ns = ap.parse_args(argv)

    failed = 0
    for case in corpus_cases(seed=ns.seed):
        rep = check_case(case, device=ns.device, verbose=ns.verbose)
        errors = rep.errors()
        worst = "clean"
        if errors:
            worst = "ERROR"
        elif rep.warnings():
            worst = "warning"
        print(f"[{case.name}] {worst}: {len(rep.diagnostics)} diagnostic(s)")
        for d in rep:
            if d.severity >= Severity.ERROR or ns.verbose:
                print(f"  {d}")
        if errors:
            failed += 1
    if failed:
        print(f"\n{failed} corpus case(s) with error-severity findings")
        return 1
    print("\nanalysis gate: all corpus cases clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
