"""The import guard: the benchmark measures the PyTorch port alone."""
from __future__ import annotations

import sys

# top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package the port was made from (repro_torch is another name)
BANNED = frozenset({"jax", "jaxlib", "flax", "repro"})


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    banned, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)
