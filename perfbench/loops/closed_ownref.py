"""The closed loop (loops/closed.py), checked against the configuration's
own named reference, perfbench/<reference>.py (its `reference` key), in
place of perfbench/reference.py, whose materialized two-paths do not fit
every configuration's size.

Each query is counted through perfbench/port/count_with.py: the port
counts as Port.count does, and the control (harness/control.py), put in
the program's place, estimates with the same named reference, which holds
the cell's size where perfbench/reference.py does not.

Parameters: those of the closed loop.
"""
from __future__ import annotations

from perfbench.harness.loops import plain
from perfbench.harness.manifest import module
from perfbench.loops.closed import Loop as Closed


class Loop(Closed):
    def reference(self):
        """The configuration's named reference module."""
        name = self.cfg["reference"]
        return module(self.cell.root / "perfbench" / f"{name}.py", f"perfbench_{name}")

    def _call(self, rels) -> tuple[int, float, int]:
        t = self.clock()
        out, info = self.program.count_with(self.query, rels, self.cfg["reference"])
        dt = self.clock() - t
        key = id(info["runner"])
        reruns = info["reruns"] - self._reruns.get(key, 0)
        self._reruns[key] = info["reruns"]
        return out, dt, reruns

    def check(self) -> dict:
        """Every answer against the named reference. Returns the compared
        numbers with their limits: exact answers, so each limit is 0."""
        ref = self.reference()
        by_index: dict[int, int] = {}
        redrawn = tuple(getattr(self.dataset, "REDRAWN", ()))
        wrong = 0
        for index, out in self.answers:
            if index not in by_index:
                tables = self.tables
                if index >= 0 and redrawn:
                    new = self.dataset.redraw(self.cfg, self.tables, self.seed, index)
                    tables = {**self.tables, **{t: new[t] for t in redrawn}}
                by_index[index] = ref.count(plain(self.atoms), tables,
                                            device=self.program.device)
            wrong += out != by_index[index]
        return {"wrong_answers": (wrong, 0), "answers": (len(self.answers), None)}
