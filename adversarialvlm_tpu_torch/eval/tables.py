"""CSV tables without pandas: the readers and the writer of the eval stages' artifacts.

The JAX package reads and writes these files through pandas, which the card's machine lacks. The
writer gives pandas' ``to_csv`` bytes: the csv module's QUOTE_MINIMAL with a ``\\n`` line end,
``True``/``False`` for booleans, a float's shortest repr and an empty cell for NaN or None. The
readers give what ``pd.read_csv`` gives: blank lines skipped, quoted fields that hold the separator
or a newline, the pandas NA strings (an empty field among them) read as NaN, and each column typed
as pandas infers it (integers, floats, booleans, else strings), so ``str()`` of a value is the
string pandas would give.
"""

from __future__ import annotations

import csv
import math
import re

# pandas' default na_values
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*", re.I)
NAN = float("nan")


class EmptyDataError(ValueError):
    """A file with no columns to parse (pandas.errors.EmptyDataError)."""


def _rows(path: str, sep: str) -> list[list[str]]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if not rows:
        raise EmptyDataError(f"No columns to parse from file {path}")
    return rows


def infer_column(cells: list[str | None]) -> list:
    """A column's values as pandas types them: NaN for NA strings and missing fields; then ints
    (floats where a NaN is among them), floats, booleans (objects beside NaN), else strings."""
    na = [c is None or c in NA_VALUES for c in cells]
    present = [c for c, n in zip(cells, na) if not n]
    if not present:
        return [NAN] * len(cells)
    if all(_INT.fullmatch(c) for c in present):
        conv = (lambda c: float(int(c))) if any(na) else int
    elif all(_FLOAT.fullmatch(c) for c in present):
        conv = float
    elif all(c in _TRUE or c in _FALSE for c in present):
        conv = _TRUE.__contains__
    else:
        conv = str
    return [NAN if n else conv(c) for c, n in zip(cells, na)]


def _mangle(header: list[str]) -> list[str]:
    """pandas' column names: an empty one is ``Unnamed: <i>``, a repeated one gains ``.<n>``."""
    out, seen = [], {}
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        base, n = name, seen.get(name, 0)
        while name in seen:
            n += 1
            name = f"{base}.{n}"
        seen[base] = n
        seen[name] = 0
        out.append(name)
    return out


def read_table(path: str, sep: str = ",") -> tuple[list[str], dict[str, list]]:
    """``pd.read_csv(path, sep=sep)``: (column names, {name: values}), the first row the header."""
    header, *data = _rows(path, sep)
    names = _mangle(header)
    for i, r in enumerate(data):
        if len(r) > len(names):
            raise ValueError(f"{path}: expected {len(names)} fields in data row {i + 1}, saw {len(r)}")
    cols = {n: infer_column([r[j] if j < len(r) else None for r in data]) for j, n in enumerate(names)}
    return names, cols


def read_rows(path: str, sep: str = ",") -> list[dict]:
    """``pd.read_csv(path, sep=sep).to_dict("records")``: one {column: value} a data row."""
    names, cols = read_table(path, sep)
    n = len(cols[names[0]]) if names else 0
    return [{name: cols[name][i] for name in names} for i in range(n)]


def read_column(path: str) -> list:
    """``pd.read_csv(path, names=[0])[0].tolist()``: one column, no header. Rows of k fields make
    the first k - 1 the index and the last the column, as pandas does when the first row has more
    fields than names."""
    rows = _rows(path, ",")
    k = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) > k:
            raise ValueError(f"{path}: expected {k} fields in line {i + 1}, saw {len(r)}")
    return infer_column([r[k - 1] if len(r) == k else None for r in rows])


def _cell(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_table(path: str, header: list | None, rows: list[list], sep: str = ",") -> None:
    """``DataFrame.to_csv(path, sep=sep, index=False)`` of ``rows`` under ``header`` (None: no
    header row). A frame with no rows and no columns writes a lone line end under a header, and
    nothing without one, as pandas does."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        if header is not None and not header:
            f.write("\n")
            return
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        if header is not None:
            w.writerow([_cell(h) for h in header])
        w.writerows([_cell(v) for v in row] for row in rows)
