"""Typed diagnostics: the currency every analysis pass trades in.

A verifier that asserts is a verifier that can only be run where a crash
is acceptable — which excludes exactly the places static checking matters
most (serving admission, CI over a corpus, debug-linting thousands of
enumerated plans). Every pass in this package therefore *returns* its
findings as `Diagnostic` values collected in a `Report`; the caller
decides whether to raise (`Report.raise_errors`), reject a request, fail
a CI job, or just print.

A Diagnostic carries:

* `rule` — a stable kebab-case identifier of the invariant violated
  (e.g. ``unbound-probe-var``). Tests and CI match on rules, never on
  message text.
* `severity` — ERROR (the plan/program is wrong and must not run),
  WARNING (legal but almost certainly not what you want — e.g. a
  mask-mode filter bound in a non-root stage, which silently defeats
  batched lane sharing), INFO (observations, e.g. baked scalar consts).
* `path` — a plan-path locator pinpointing *where*: dotted segments like
  ``stage[__root].node[2].probe[1]`` or ``stage[__stage1].cap[0]``, so a
  finding over a 40-node chain is actionable without a debugger.
* `message` — the human sentence.

The rule catalogue lives in `src/repro_torch/analysis/README.md`; adding a rule
means adding its emitter in planlint/launch_audit, a case that trips it
in tests/test_torch_analysis.py, and a README row.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    """Ordered so `max(found).severity` is the report's worst finding."""

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self):
        return self.name.lower()


@dataclass(frozen=True)
class Diagnostic:
    """One finding of one analysis pass (see module docstring)."""

    rule: str
    severity: Severity
    path: str
    message: str

    def __str__(self):
        return f"{self.severity}[{self.rule}] at {self.path}: {self.message}"


class PlanVerificationError(ValueError):
    """Raised (only on request — `Report.raise_errors`) when a report
    holds error-severity diagnostics. Carries the full report so callers
    that catch it (the serving engine's admission path) can attribute the
    rejection without re-running the pass."""

    def __init__(self, report: "Report"):
        self.report = report
        errs = report.errors()
        head = f"{len(errs)} plan verification error(s)"
        super().__init__(head + "".join(f"\n  {d}" for d in errs))


@dataclass
class Report:
    """An ordered collection of diagnostics with the convenience surface
    every caller wants: severity filters, merging, raise-on-error."""

    diagnostics: list[Diagnostic] = field(default_factory=list)

    def add(self, rule: str, severity: Severity, path: str, message: str) -> None:
        self.diagnostics.append(Diagnostic(rule, severity, path, message))

    def error(self, rule: str, path: str, message: str) -> None:
        self.add(rule, Severity.ERROR, path, message)

    def warning(self, rule: str, path: str, message: str) -> None:
        self.add(rule, Severity.WARNING, path, message)

    def info(self, rule: str, path: str, message: str) -> None:
        self.add(rule, Severity.INFO, path, message)

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        return self

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    def rules(self) -> set[str]:
        """The set of rules that fired (the mutation-fuzz contract: a
        corrupted plan's report must *name* the injected defect class)."""
        return {d.rule for d in self.diagnostics}

    @property
    def ok(self) -> bool:
        """True iff no error-severity findings (warnings don't fail)."""
        return not self.errors()

    def raise_errors(self) -> "Report":
        """Raise PlanVerificationError if any error-severity diagnostic is
        present; otherwise return self (chainable)."""
        if not self.ok:
            raise PlanVerificationError(self)
        return self

    def __bool__(self):  # truthiness = "found anything at all"
        return bool(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __str__(self):
        if not self.diagnostics:
            return "Report(clean)"
        return "\n".join(str(d) for d in self.diagnostics)
