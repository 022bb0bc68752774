"""The adaptive executor's reruns (retries after an overflow plus
reshapes), over the window's queries."""


def read(run):
    return run.per_query(run.counters.get("reruns", 0))
