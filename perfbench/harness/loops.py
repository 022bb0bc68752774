"""The one traffic generator. A traffic mix, perfbench/traffic/<mix>.json,
is data: it names its loop, perfbench/loops/<loop>.py (a module holding
`Loop`), and holds the loop's parameters. A loop's parameters may name
further parts by file in the same way, as the open loop names its arrival
process (perfbench/arrivals/<name>.py) and its constants
(perfbench/constants/<name>.py). A mix that needs behaviour no loop or part
has brings a new file; none of these is listed anywhere.

A loop is built as Loop(cell, tables, program, seed) and offers
setup(seconds), window(rec, seconds, stretch), one_more(), release() and
check() (harness/cell.py drives them). Every loop draws its set of sizes,
arrivals and constants from the configuration's structure seed and lets
the run's seed order them (and relabel the data), so every seed asks for
the same work.
"""
from __future__ import annotations


def atoms_of(config: dict, name: str) -> list:
    return [(t, tuple(vs), alias) for t, vs, alias in config["queries"][name]]


def plain(atoms) -> list:
    return [(t, vs) for t, vs, _alias in atoms]


def loop_class(cell):
    """The mix's loop: perfbench/loops/<loop>.py's Loop."""
    return cell.part("loops", cell.traffic["loop"]).Loop
