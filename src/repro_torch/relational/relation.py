"""Column-oriented relation storage (the paper stores raw data column-wise,
each column a vector, as in column-oriented databases — Sec 4.2)."""
from __future__ import annotations

import numpy as np


class Relation:
    """A named, column-oriented relation with bag semantics.

    Columns are int64 numpy arrays (join attributes are dictionary-encoded
    upstream; payload columns may be any dtype). Rows are implicit: row i is
    (col[i] for col in columns). Duplicate rows are allowed (bag semantics).
    """

    def __init__(self, name: str, columns: dict[str, np.ndarray]):
        self.name = name
        self.columns = {k: np.asarray(v) for k, v in columns.items()}
        lens = {len(v) for v in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns in relation {name}: {lens}")
        self.num_rows = lens.pop() if lens else 0

    @property
    def schema(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    def cols(self, names) -> list[np.ndarray]:
        return [self.columns[n] for n in names]

    def gather(self, names, rows: np.ndarray) -> list[np.ndarray]:
        """Gather the given columns at the given row offsets."""
        return [self.columns[n][rows] for n in names]

    def select(self, mask: np.ndarray) -> "Relation":
        return Relation(self.name, {k: v[mask] for k, v in self.columns.items()})

    def rename(self, mapping: dict[str, str], name: str | None = None) -> "Relation":
        return Relation(
            name or self.name,
            {mapping.get(k, k): v for k, v in self.columns.items()},
        )

    def distinct_counts(self) -> dict[str, int]:
        return {k: len(np.unique(v)) for k, v in self.columns.items()}

    def __len__(self) -> int:
        return self.num_rows

    def __repr__(self) -> str:
        return f"Relation({self.name}, schema={self.schema}, rows={self.num_rows})"

    @staticmethod
    def from_tuples(name: str, schema, rows) -> "Relation":
        arr = np.asarray(list(rows), dtype=np.int64)
        if arr.size == 0:
            arr = arr.reshape(0, len(schema))
        return Relation(name, {v: arr[:, i] for i, v in enumerate(schema)})

    def to_tuples(self) -> list[tuple]:
        cols = list(self.columns.values())
        return [tuple(int(c[i]) for c in cols) for i in range(self.num_rows)]
