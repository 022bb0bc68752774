"""Constants by rank: rank k (0 the value that binds most rows) drawn with
weight Zipf(constants_zipf_a), ranks past the last value wrapping round,
from the structure seed, in an order the run's seed draws."""
import numpy as np


def ranks(n: int, n_values: int, structure, run, params: dict) -> np.ndarray:
    r = (structure.zipf(float(params["constants_zipf_a"]), n) - 1) % n_values
    return r[run.permutation(n)]
