"""The Star Schema Benchmark (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009) at
scale factor `sf`, as its dbgen draws it, cut to the columns and rows its
query flight 3 reads:

* lineorder: 1,500,000 * sf orders of 1 to 7 lines each (uniform, so
  about 6,000,000 * sf rows); an order's customer uniform over
  1..30,000 * sf, a multiple of 3 moved to its neighbour (dbgen's
  CUST_MORTALITY: a third of the customers order nothing); its date
  uniform over 1992-01-01 .. 1998-12-31 less 151 days; a line's supplier
  uniform over 1..2,000 * sf. Held: (custkey, suppkey, orderdate).
* customer and supplier: a nation uniform over 25 and a digit uniform over
  10 make the city (nation * 10 + digit, 250 cities); held are the keys
  whose city is one of the query's, the query's selection applied before
  the join, as Free Join's evaluation applies it.
* date: the 2,557 days of 1992-1998; held are those of the query's years.

The tables are drawn from the configuration's `structure_seed` (lineorder
by torch on the run's device, whose draw differs from the CPU's; the rest
by numpy); the run's seed relabels the keys (one permutation each of customers, suppliers and
days) and shuffles the rows, so every seed gets the same join up to names
and order. A query over freshly loaded tables (`redraw`) takes copies of
lineorder and date and draws its two cities anew, from the structure seed
and the query's index, as SSB's query parameters vary from run to run.
"""
from __future__ import annotations

import numpy as np
import torch

DAYS = np.arange("1992-01-01", "1999-01-01", dtype="datetime64[D]")
YEARS = DAYS.astype("datetime64[Y]").astype(np.int64) + 1970
LAST_ORDER_DAY = len(DAYS) - 1 - 151


def sizes(params: dict) -> dict[str, int]:
    sf = params["sf"]
    return {"orders": int(1_500_000 * sf), "customers": int(30_000 * sf),
            "suppliers": int(2_000 * sf)}


def _lineorder(params: dict, device: str) -> dict[str, torch.Tensor]:
    """lineorder's three keys, unlabeled: 1-based customer and supplier
    keys and a 0-based day index, drawn by torch on `device`."""
    n = sizes(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params["structure_seed"]))

    def draw(lo: int, hi: int, k: int) -> torch.Tensor:
        return torch.randint(lo, hi, (k,), generator=gen, device=device)

    lines = draw(1, 8, n["orders"])
    cust = draw(1, n["customers"] + 1, n["orders"])
    third = cust % 3 == 0
    cust = torch.where(third & (cust == n["customers"]), cust - 1, torch.where(third, cust + 1, cust))
    day = draw(0, LAST_ORDER_DAY + 1, n["orders"])
    total = int(lines.sum())
    return {"c": torch.repeat_interleave(cust, lines), "s": draw(1, n["suppliers"] + 1, total),
            "d": torch.repeat_interleave(day, lines)}


def _cities_of(params: dict) -> dict[str, np.ndarray]:
    """Each customer's and each supplier's city."""
    n = sizes(params)
    rng = np.random.default_rng([params["structure_seed"], 1])
    return {k: rng.integers(0, 25, n[k]) * 10 + rng.integers(0, 10, n[k])
            for k in ("customers", "suppliers")}


def _labels(params: dict, seed: int) -> dict[str, np.ndarray]:
    """The run's relabelings of customer, supplier and day keys."""
    n = sizes(params)
    run = np.random.default_rng(seed)
    return {"c": run.permutation(n["customers"] + 1).astype(np.int64),
            "s": run.permutation(n["suppliers"] + 1).astype(np.int64),
            "d": run.permutation(len(DAYS)).astype(np.int64)}


def _dims(params: dict, city: dict, lab: dict, cities) -> dict:
    return {"customer": {"c": lab["c"][1 + np.flatnonzero(np.isin(city["customers"], cities))]},
            "supplier": {"s": lab["s"][1 + np.flatnonzero(np.isin(city["suppliers"], cities))]}}


def generate(params: dict, seed: int, device: str = "cpu") -> dict[str, dict[str, np.ndarray]]:
    """{"lineorder": {"c", "s", "d"}, "customer": {"c"}, "supplier": {"s"},
    "date": {"d"}}, int64 columns, the dimensions filtered to the query's
    cities (`cities`) and years (`years`, inclusive). lineorder is drawn on
    `device` (the card in a run), the rest by numpy."""
    lo = _lineorder(params, device)
    city = _cities_of(params)
    lab = _labels(params, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**64)
    order = torch.randperm(len(lo["c"]), generator=gen, device=device)
    y0, y1 = params["years"]
    out = {"lineorder": {v: torch.as_tensor(lab[v], device=device)[c[order]].cpu().numpy()
                         for v, c in lo.items()}}
    out.update(_dims(params, city, lab, params["cities"]))
    out["date"] = {"d": lab["d"][np.flatnonzero((YEARS >= y0) & (YEARS <= y1))]}
    return out


def cities(params: dict, index: int) -> list[int]:
    """The two cities of the `index`-th query over freshly loaded tables."""
    rng = np.random.default_rng([params["structure_seed"], index])
    return sorted(int(c) for c in rng.choice(250, 2, replace=False))


def redraw(params: dict, tables: dict, seed: int, index: int) -> dict:
    """Tables for the `index`-th query over freshly loaded data: copies of
    lineorder and date, customer and supplier filtered to two cities drawn
    anew."""
    city = _cities_of(params)
    lab = _labels(params, seed)
    out = {t: {v: c.copy() for v, c in tables[t].items()} for t in ("lineorder", "date")}
    out.update(_dims(params, city, lab, cities(params, index)))
    return out


# the tables `redraw` draws anew; it copies the others unchanged
REDRAWN = ("customer", "supplier")
