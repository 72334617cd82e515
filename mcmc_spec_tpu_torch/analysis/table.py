"""A small column table in place of a pandas DataFrame (the card's machine has no pandas).

:class:`Table` holds named 1-D numpy columns of one length: ``t["col"]`` is a
column, ``t[mask]`` (a boolean or integer array) and ``t[["a", "b"]]`` are
tables, ``len(t)`` counts rows, ``t.rows()`` yields each row as a dict (what
``iterrows`` gives the JAX module) and ``t.row(i)`` one.  ``from_rows`` builds
a table from a list of dicts as ``pd.DataFrame(rows)`` does (the keys' union
in first-seen order, NaN where a row lacks one).  ``read_csv`` / ``read_table``
and ``to_csv`` read and write text as the JAX module's pandas calls do:

* a column is int64 when every cell parses as an integer, float64 when every
  non-empty cell parses as a number (an empty cell is NaN), else strings;
  ``str_cols`` keeps named columns strings (``dtype={"system": str}``);
* ``to_csv`` writes a header, floats as Python's ``repr``, NaN as an empty
  cell, and quotes a cell only where it holds the separator, a quote or a
  line break (pandas' ``QUOTE_MINIMAL``).

``read_table`` is ``pd.read_csv(path, sep=None, engine="python",
comment="#", skipinitialspace=True)``: a ``#`` starts a comment, blank lines
are skipped, and the separator is the one ``csv.Sniffer`` finds in the first
line.
"""
from __future__ import annotations

import csv
import io
import math
from typing import Iterable, Optional

import numpy as np


def _parse(cell: str):
    """(int or None, float or None) of one cell."""
    s = cell.strip()
    try:
        return int(s), float(s)
    except ValueError:
        pass
    try:
        return None, float(s)
    except ValueError:
        return None, None


def _infer_column(cells, as_str: bool = False) -> np.ndarray:
    """A column of text cells typed as pandas' parser types it (module docstring)."""
    cells = list(cells)
    if as_str:
        return np.array(cells, dtype=object)
    parsed = [_parse(c) for c in cells]
    if cells and all(i is not None for i, _ in parsed):
        return np.array([i for i, _ in parsed], dtype=np.int64)
    if all(f is not None or c.strip() == "" for (_, f), c in zip(parsed, cells)):
        return np.array([np.nan if f is None else f for _, f in parsed], dtype=np.float64)
    return np.array([np.nan if c == "" else c for c in cells], dtype=object)


def _column_of(values) -> np.ndarray:
    """A column of Python values, typed as a DataFrame built from them types it."""
    vals = list(values)
    if vals and all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
                    for v in vals):
        return np.array(vals, dtype=np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in vals):
        return np.array(vals, dtype=np.float64)
    return np.array(vals, dtype=object)


def to_numeric(col) -> np.ndarray:
    """``pd.to_numeric(col, errors="coerce")``: float64, NaN where a cell is no number."""
    col = np.asarray(col)
    if col.dtype != object:
        return col.astype(np.float64)
    out = np.full(len(col), np.nan)
    for i, v in enumerate(col):
        if isinstance(v, str):
            f = _parse(v)[1]
            out[i] = np.nan if f is None else f
        elif v is not None:
            out[i] = float(v)
    return out


def as_str(col) -> np.ndarray:
    """``col.astype(str)``: each value as pandas writes it (ints without a point)."""
    out = []
    for v in np.asarray(col):
        if isinstance(v, (float, np.floating)):
            out.append(repr(float(v)))
        elif isinstance(v, (int, np.integer)):
            out.append(str(int(v)))
        else:
            out.append(str(v))
    return np.array(out, dtype=object)


class Table:
    """Named 1-D numpy columns of one length (module docstring)."""

    def __init__(self, columns: Optional[dict] = None):
        self._cols = {}
        for name, col in (columns or {}).items():
            self[name] = col

    @classmethod
    def from_rows(cls, rows: Iterable[dict]) -> "Table":
        rows = list(rows)
        names = []
        for r in rows:
            names += [k for k in r if k not in names]
        return cls({k: _column_of(r.get(k, np.nan) for r in rows) for k in names})

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list) and all(isinstance(k, str) for k in key):
            return Table({k: self._cols[k] for k in key})
        idx = np.asarray(key)
        return Table({k: v[idx] for k, v in self._cols.items()})

    def __setitem__(self, name: str, values):
        col = values if isinstance(values, np.ndarray) else _column_of(values)
        if col.ndim != 1 or (self._cols and name not in self._cols and len(col) != len(self)):
            raise ValueError(f"column {name!r} of shape {col.shape} for a table of "
                             f"{len(self)} rows")
        self._cols[name] = col

    def row(self, i: int) -> dict:
        return {k: v[i] for k, v in self._cols.items()}

    def rows(self):
        for i in range(len(self)):
            yield self.row(i)

    # ------------------------------------------------------------- text
    @classmethod
    def read_csv(cls, path, str_cols=()) -> "Table":
        """A comma-separated file with a header, typed per column (module docstring)."""
        with open(path, newline="") as f:
            return cls._from_records(list(csv.reader(f)), str_cols)

    @classmethod
    def read_table(cls, path) -> "Table":
        """A delimited file whose separator is sniffed, ``#`` comments and blank lines
        dropped and leading spaces of a cell skipped (module docstring)."""
        with open(path, newline="") as f:
            lines = [line.split("#", 1)[0].rstrip("\r\n") for line in f]
        lines = [line for line in lines if line.strip()]
        if not lines:
            return cls()
        try:
            dialect = csv.Sniffer().sniff(lines[0])
            delimiter = dialect.delimiter
        except csv.Error:
            delimiter = ","
        reader = csv.reader(lines, delimiter=delimiter, skipinitialspace=True)
        return cls._from_records(list(reader), ())

    @classmethod
    def _from_records(cls, records, str_cols) -> "Table":
        header, body = records[0], [r for r in records[1:] if r]
        width = len(header)
        body = [(r + [""] * width)[:width] for r in body]
        return cls({name: _infer_column((r[j] for r in body), as_str=name in str_cols)
                    for j, name in enumerate(header)})

    def to_csv(self, path) -> None:
        """Write ``path`` as ``DataFrame.to_csv(path, index=False)`` writes it."""
        buf = io.StringIO()
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(self.columns)
        for r in self.rows():
            w.writerow([_cell(v) for v in r.values()])
        with open(path, "w") as f:
            f.write(buf.getvalue())


def _cell(v) -> str:
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)
