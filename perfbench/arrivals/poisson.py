"""Poisson arrivals: exponential gaps drawn from the structure seed, put in
an order the run's seed draws, and scaled to fill the window exactly, so
every seed offers the same gaps."""
import numpy as np


def due(n: int, seconds: float, structure, run, params: dict) -> np.ndarray:
    """The n requests' due offsets in seconds, ascending, the last at
    `seconds`."""
    gaps = structure.exponential(1.0, n)[run.permutation(n)]
    return np.cumsum(gaps) / gaps.sum() * seconds
