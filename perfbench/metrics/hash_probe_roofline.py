"""K1 (hash_probe): the bound time of its launches in one query after the
window over their device time (torch.profiler, each launch between two
markers), in percent. The bound counts the query rows read, one int32
result written and the 32-byte sectors of the table the probes reach, and
6 operations a key column per row plus k + 3 per probe step."""
from perfbench.harness.bounds import nbytes, probe_reach, share


def hold(args):
    """What a launch keeps for its bound: its inputs' contents."""
    import torch

    return tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args)


def work(held) -> tuple[int, int]:
    slots, keys, q, budget = held
    k = q.shape[1]
    steps, table = probe_reach(slots, keys, q, budget)
    return nbytes(q) + 4 * q.shape[0] + table, q.shape[0] * 6 * k + steps * (k + 3)


KERNEL = {"wrapper": "repro_torch.kernels.ops:hash_probe", "hold": hold, "work": work}


def read(run):
    return share(run.launches.get(KERNEL["wrapper"]))
