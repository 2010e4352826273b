"""The eval harness's CSV files, read and written without pandas.

The JAX harness reads its label and image lists with ``pd.read_csv`` and
writes raw similarities with ``pd.DataFrame(sims).to_csv(index=False)``.
This module gives the same results for those files and nothing more
general:

- a header row, or none with the caller's ``names``; any one-character
  separator; quoted fields as the ``csv`` module reads them; blank lines
  skipped;
- pandas' default NA strings (the empty cell among them) read as NaN;
- a column whose other cells all read as integers is int64 (float64 when
  it also holds an NA cell), one whose cells all read as numbers is
  float64, anything else is an object array of the strings with NaN for
  NA; numbers may carry spaces around them, as pandas' parser allows (so
  SIIM's literal " -1" stays a string beside RLE strings, but a column
  of " -1" alone reads as the integer -1);
- ``Table.values(names)`` stacks columns with the dtype
  ``DataFrame[names].values`` has.

Not supported: boolean columns, dates, comments, index columns, other
quoting or NA options.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?[0-9]+\s*")
_FLOAT = re.compile(
    r"\s*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|inf|infinity)\s*", re.IGNORECASE)
_I64 = (-(2**63), 2**63 - 1)


def isna(value) -> bool:
    """``pd.isna`` of one cell as this module returns it."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _column(cells: List[str]) -> np.ndarray:
    na = [c in NA_STRINGS for c in cells]
    present = [c for c, n in zip(cells, na) if not n]
    if not present:
        return np.full(len(cells), np.nan)
    if all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if not any(na) and _I64[0] <= min(ints) and max(ints) <= _I64[1]:
            return np.asarray(ints, np.int64)
    if all(_FLOAT.fullmatch(c) for c in present):
        return np.asarray([np.nan if n else float(c) for c, n in zip(cells, na)], np.float64)
    out = np.empty(len(cells), object)
    out[:] = [np.nan if n else c for c, n in zip(cells, na)]
    return out


class Table:
    """Named columns of equal length, in file order."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = list(columns)
        self._data = dict(columns)

    def __len__(self) -> int:
        return len(next(iter(self._data.values()))) if self._data else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self._data[name]

    def values(self, names: Sequence[str]) -> np.ndarray:
        """(rows, len(names)): int64 if every column is, float64 if every
        column is numeric, else object."""
        cols = [self._data[n] for n in names]
        kinds = {c.dtype.kind for c in cols}
        dtype = object if "O" in kinds else np.result_type(*(c.dtype for c in cols))
        out = np.empty((len(self), len(cols)), dtype)
        for j, c in enumerate(cols):
            out[:, j] = c
        return out


def read_csv(path: str, sep: str = ",", names: Optional[Sequence[str]] = None) -> Table:
    """``pd.read_csv(path, sep=sep, names=names)`` for the harness's files."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if names is None:
        header, rows = rows[0], rows[1:]
    else:
        header = list(names)
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names {header}")
    width = len(header)
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header {width}")
        r.extend([""] * (width - len(r)))
    return Table({h: _column([r[j] for r in rows]) for j, h in enumerate(header)})


def _cell(value) -> str:
    if isinstance(value, (float, np.floating)):
        return "" if math.isnan(value) else str(value)
    return "" if value is None else str(value)


def write_csv(path: str, columns: Dict[str, Sequence]) -> None:
    """``pd.DataFrame(columns).to_csv(path, index=False)``: NaN as an empty
    cell, floats as their shortest repr, quoting as pandas' (minimal)."""
    names = list(columns)
    n = len(columns[names[0]]) if names else 0
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for i in range(n):
            w.writerow([_cell(columns[c][i]) for c in names])


def write_matrix_csv(path: str, array: np.ndarray) -> None:
    """``pd.DataFrame(array).to_csv(path, index=False)`` of a 2-D array:
    columns named 0..P-1."""
    array = np.asarray(array)
    write_csv(path, {str(j): array[:, j] for j in range(array.shape[1])})
