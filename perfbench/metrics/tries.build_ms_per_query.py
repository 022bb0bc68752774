"""Milliseconds a query spent in the trie cache's entry (column uploads and
trie builds, the device synchronized at both ends), over the queries."""
SPANS = {"tries": {"target": "repro_torch.core.compiled:TRIE_CACHE.get", "sync": True}}


def read(run):
    spans = run.spans.get("tries")
    return run.per_query(sum(spans) * 1e3) if spans else None
