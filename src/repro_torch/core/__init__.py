# Free Join (Wang, Willsey, Suciu — SIGMOD 2023) on PyTorch: plans
# (binary2fj + factor), the optimizer, the capacity planner and the
# static-shape compiled path.
from repro_torch.core.api import ExecOptions, compiled_free_join, to_sorted_tuples
from repro_torch.core.capacity import (
    CapacityPlan,
    ChainCapacityPlan,
    agm_bound,
    plan_capacities,
    plan_chain_capacities,
)
from repro_torch.core.compiled import (
    TRIE_CACHE,
    AdaptiveExecutor,
    StaticSchedule,
    make_chain_executor,
    make_executor,
)
from repro_torch.core.optimizer import JoinOrderOptimizer, Stats, optimize
from repro_torch.core.plan import BinaryPlan, FreeJoinPlan, Subatom, binary2fj, factor, linear
from repro_torch.core.relcache import FEEDBACK, CardFeedback

__all__ = [
    "AdaptiveExecutor",
    "BinaryPlan",
    "CapacityPlan",
    "CardFeedback",
    "ChainCapacityPlan",
    "ExecOptions",
    "FEEDBACK",
    "FreeJoinPlan",
    "JoinOrderOptimizer",
    "StaticSchedule",
    "Stats",
    "Subatom",
    "TRIE_CACHE",
    "agm_bound",
    "binary2fj",
    "compiled_free_join",
    "factor",
    "linear",
    "make_chain_executor",
    "make_executor",
    "optimize",
    "plan_capacities",
    "plan_chain_capacities",
    "to_sorted_tuples",
]
