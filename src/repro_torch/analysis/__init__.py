"""Static analysis over Free Join plans and the calls of their runners.

Two passes (see planlint.py and launch_audit.py for the invariant
stories), one diagnostic currency (diagnostics.py), one corpus of real
planner output to keep the rules honest (corpus.py), and a CLI gate
(``python -m repro_torch.analysis``) that runs both over the corpus.

Entry points re-exported here are the package's public surface; the
rule catalogue and severity contract are documented in README.md.
"""
from repro_torch.analysis.diagnostics import (
    Diagnostic,
    PlanVerificationError,
    Report,
    Severity,
)
from repro_torch.analysis.launch_audit import (
    LaunchTrace,
    audit_runner,
    audit_trace,
    trace_runner,
)
from repro_torch.analysis.planlint import (
    lint_capacities,
    lint_chain,
    lint_plan,
    lint_query,
    lint_schedule,
    lint_stage_dag,
    lint_template,
    lint_tree,
)

__all__ = [
    "Diagnostic",
    "LaunchTrace",
    "PlanVerificationError",
    "Report",
    "Severity",
    "audit_runner",
    "audit_trace",
    "trace_runner",
    "lint_capacities",
    "lint_chain",
    "lint_plan",
    "lint_query",
    "lint_schedule",
    "lint_stage_dag",
    "lint_template",
    "lint_tree",
]
