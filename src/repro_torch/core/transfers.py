"""The compiled path's crossings between host and device, in one place.

Every read-back the compiled path makes (the need vectors, the count, the
rows) and every upload (relation columns, appended rows, tombstoned row
ids, filter constants) goes through `TRANSFERS`. Each is a blocking copy:
a read-back waits for the device's queue to drain, and an upload from
pageable host memory synchronizes too. So on the card `syncs` counts the
host synchronizations of these copies, and on the CPU the same calls pass
through the same counter, so a CPU run counts what the card would. The
launch audit (repro_torch/analysis/launch_audit.py) records a warm call's
crossings here, and on the card holds its count to the one
torch.cuda.set_sync_debug_mode reports.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


class Transfers:
    """Counts blocking host<->device copies; `record()` also lists them."""

    def __init__(self):
        self.syncs = 0  # blocking copies: read-backs and uploads
        self._events: list | None = None
        self._depth = 0

    @property
    def crossing(self) -> bool:
        """True while a counted copy runs: the audit's op recorder skips
        the tensor ops the copy itself dispatches."""
        return self._depth > 0

    @contextmanager
    def record(self):
        """Collect ("read" | "upload", what, elements) for every crossing
        made inside the block."""
        prev, self._events = self._events, []
        try:
            yield self._events
        finally:
            self._events = prev

    def _note(self, kind: str, what: str, elements: int) -> None:
        self.syncs += 1
        if self._events is not None:
            self._events.append((kind, what, int(elements)))

    def to_host(self, t: torch.Tensor, what: str) -> np.ndarray:
        """One blocking read-back of `t` as a host numpy array."""
        self._note("read", what, t.numel())
        self._depth += 1
        try:
            return t.cpu().numpy()
        finally:
            self._depth -= 1

    def to_device(self, host, device, what: str) -> torch.Tensor:
        """One blocking upload of the host array `host` to `device`."""
        host = np.ascontiguousarray(host)
        self._note("upload", what, host.size)
        self._depth += 1
        try:
            return torch.as_tensor(host).to(device)
        finally:
            self._depth -= 1


TRANSFERS = Transfers()
