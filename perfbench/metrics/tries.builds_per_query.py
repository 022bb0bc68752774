"""Full trie builds (TRIE_CACHE.builds) over the window's queries."""
COUNTERS = {"trie_builds": "repro_torch.core.compiled:TRIE_CACHE.builds"}


def read(run):
    return run.per_query(run.counters.get("trie_builds"))
