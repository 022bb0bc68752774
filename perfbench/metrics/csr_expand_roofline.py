"""K2 (csr_expand): the bound time of its launches in one query after the
window over their device time (torch.profiler, each launch between two
markers), in percent. For consecutive output slots it counts a monotone
array's entries at or below the slot: the inputs read once, one int64 pair
written a slot, one compare and one select per entry and per live slot."""
from perfbench.harness.bounds import meta, nbytes, share


def hold(args):
    """Shapes, and the live total (a one-element tensor)."""
    return (meta(args[0]), meta(args[1]), args[2].clone(), args[3])


def work(held) -> tuple[int, int]:
    starts, base, total, cap = held
    live = min(cap, int(total))
    return nbytes(starts) + nbytes(base) + 4 + 8 * cap, 2 * (starts.shape[0] + max(live, 0))


KERNEL = {"wrapper": "repro_torch.kernels.ops:csr_expand", "hold": hold, "work": work}


def read(run):
    return share(run.launches.get(KERNEL["wrapper"]))
