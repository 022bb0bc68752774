# Free Join (Wang, Willsey, Suciu — SIGMOD 2023) on PyTorch: plans
# (binary2fj + factor), the optimizer, COLT and the vectorized eager
# engine with its baselines, the capacity planner and the static-shape
# compiled path, with its fault injection and memory governor.
from repro_torch.core import faults, membudget
from repro_torch.core.api import (
    ExecOptions,
    binary_join,
    compiled_free_join,
    free_join,
    generic_join,
    to_sorted_tuples,
)
from repro_torch.core.capacity import (
    CapacityPlan,
    CapacityQuotaError,
    ChainCapacityPlan,
    agm_bound,
    plan_capacities,
    plan_chain_capacities,
)
from repro_torch.core.colt import Colt
from repro_torch.core.compiled import (
    TRIE_CACHE,
    AdaptiveExecutor,
    StaticSchedule,
    make_chain_executor,
    make_executor,
)
from repro_torch.core.engine import ExecStats, execute, materialize
from repro_torch.core.optimizer import JoinOrderOptimizer, Stats, optimize
from repro_torch.core.plan import BinaryPlan, FreeJoinPlan, Subatom, binary2fj, factor, linear
from repro_torch.core.relcache import FEEDBACK, CardFeedback

__all__ = [
    "AdaptiveExecutor",
    "BinaryPlan",
    "CapacityPlan",
    "CapacityQuotaError",
    "CardFeedback",
    "ChainCapacityPlan",
    "Colt",
    "ExecOptions",
    "ExecStats",
    "FEEDBACK",
    "FreeJoinPlan",
    "JoinOrderOptimizer",
    "StaticSchedule",
    "Stats",
    "Subatom",
    "TRIE_CACHE",
    "agm_bound",
    "binary2fj",
    "binary_join",
    "compiled_free_join",
    "execute",
    "factor",
    "faults",
    "free_join",
    "generic_join",
    "linear",
    "make_chain_executor",
    "make_executor",
    "materialize",
    "membudget",
    "optimize",
    "plan_capacities",
    "plan_chain_capacities",
    "to_sorted_tuples",
]
