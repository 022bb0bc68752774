"""K4 (radix_rank, a pass of the trie builds' sort): the bound time of its
launches in one query after the window over their device time
(torch.profiler, each launch between two markers), in percent. It ranks
each key by a search over its digit's counts: the inputs read once, one
int32 rank written a key, 4 log2(n) operations a key."""
from perfbench.harness.bounds import meta, nbytes, share


def hold(args):
    """Shapes alone."""
    return tuple(meta(x) for x in args)


def work(held) -> tuple[int, int]:
    csum, kd, kt = held
    return (nbytes(csum) + nbytes(kd) + nbytes(kt) + 4 * kd.shape[0],
            kd.shape[0] * 4 * kd.shape[0].bit_length())


KERNEL = {"wrapper": "repro_torch.kernels.radix_sort:radix_rank", "hold": hold, "work": work}


def read(run):
    return share(run.launches.get(KERNEL["wrapper"]))
