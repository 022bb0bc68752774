"""K3 (compact): the bound time of its launches in one query after the
window over their device time (torch.profiler, each launch between two
markers), in percent. For consecutive output slots it finds the live rows
in a running count: the count read once, one int32 written a slot, one
compare and one select per entry and per live slot."""
from perfbench.harness.bounds import meta, nbytes, share


def hold(args):
    """Shapes, and the live count (a one-element tensor)."""
    return (meta(args[0]), args[1].clone(), args[2])


def work(held) -> tuple[int, int]:
    csum, live, cap = held
    n_live = min(cap, int(live))
    return nbytes(csum) + 4 + 4 * cap, 2 * (csum.shape[0] + max(n_live, 0))


KERNEL = {"wrapper": "repro_torch.kernels.ops:compact", "hold": hold, "work": work}


def read(run):
    return share(run.launches.get(KERNEL["wrapper"]))
