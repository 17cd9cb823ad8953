"""Column tables: the port's stand-in for the pandas DataFrames of the JAX
package's metric and decode functions (the machine with the card has no
pandas).

A table is any mapping from a column name to a sequence, all of one length:
`table["filename"]`, `table["onset"]`, ... A pandas DataFrame is one too, so
callers that have pandas may pass DataFrames. The port's functions return
tables as dicts of numpy arrays. Rows whose `event_label` is missing (None
or NaN) drop, as `DataFrame.dropna(subset=["event_label"])` drops them.
"""

from __future__ import annotations

import numpy as np

EVENT_COLUMNS = ("event_label", "onset", "offset", "filename")


def columns(table) -> list[str]:
    """The table's column names, in order."""
    return [str(c) for c in (table.columns if hasattr(table, "columns") else table)]


def n_rows(table) -> int:
    if table is None:
        return 0
    cols = columns(table)
    return len(table[cols[0]]) if cols else 0


def column(table, name: str) -> np.ndarray:
    col = table[name]
    return col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col)


def is_missing(label) -> bool:
    return label is None or label != label  # NaN is not equal to itself


def events(table) -> list[tuple[str, float, float, str]]:
    """(filename, onset, offset, event_label) of each row with a label, in
    table order."""
    if not n_rows(table):
        return []
    return [
        (f, float(on), float(off), lab)
        for f, on, off, lab in zip(table["filename"], table["onset"], table["offset"],
                                   table["event_label"])
        if not is_missing(lab)
    ]


def labels(table) -> set:
    """The distinct event labels of a table, missing ones left out."""
    if not n_rows(table):
        return set()
    return {lab for lab in table["event_label"] if not is_missing(lab)}


def event_table(rows=(), event_label=None, onset=None, offset=None, filename=None) -> dict:
    """An event table from rows (event_label, onset, offset, filename), or
    from its four columns."""
    if event_label is None:
        rows = list(rows)
        event_label, onset, offset, filename = (
            [r[i] for r in rows] for i in range(4)) if rows else ([], [], [], [])
    return {
        "event_label": np.asarray(event_label, dtype=object),
        "onset": np.asarray(onset, dtype=np.float64),
        "offset": np.asarray(offset, dtype=np.float64),
        "filename": np.asarray(filename, dtype=object),
    }


def concat(tables) -> dict:
    """Rows of several event tables, one after another."""
    tables = [t for t in tables if n_rows(t)]
    if not tables:
        return event_table()
    return event_table(**{c: np.concatenate([column(t, c) for t in tables])
                          for c in EVENT_COLUMNS})


# columns the recipes read, with the type pandas.read_csv(sep="\t") gives them
STRING_COLUMNS = ("filename", "event_label", "event_labels")
FLOAT_COLUMNS = ("onset", "offset", "confidence", "duration")


def _parse(name: str, values: list[str]) -> np.ndarray:
    """One tsv column: float64 (NaN for an empty field) for the numeric
    columns and for any other column whose fields all parse as numbers;
    else strings, NaN for an empty field."""
    if name not in STRING_COLUMNS:
        try:
            return np.asarray([float(v) if v != "" else np.nan for v in values], np.float64)
        except ValueError:
            if name in FLOAT_COLUMNS:
                raise
    return np.asarray([v if v != "" else np.nan for v in values] or [], dtype=object)


def read_tsv(path) -> dict:
    """A tab-separated file with a header row -> a column table, read with
    csv, as pd.read_csv(path, sep="\\t") reads the recipes' columns (blank
    lines skipped)."""
    import csv

    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    header, body = rows[0], rows[1:]
    return {name: _parse(name, [r[j] if j < len(r) else "" for r in body])
            for j, name in enumerate(header)}


def as_columns(table) -> dict:
    """Any table (a dict of sequences or a DataFrame) -> a dict of numpy
    arrays."""
    return {c: column(table, c) for c in columns(table)}


def take(table, rows) -> dict:
    """The rows at the given positions, in that order (DataFrame.iloc)."""
    rows = np.asarray(rows, dtype=np.int64)
    return {c: column(table, c)[rows] for c in columns(table)}


def _missing(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    return np.fromiter((is_missing(v) for v in col), bool, len(col))


def dropna(table) -> dict:
    """The rows with no missing field (DataFrame.dropna())."""
    t = as_columns(table)
    keep = np.ones(n_rows(t), bool)
    for col in t.values():
        keep &= ~_missing(col)
    return take(t, np.flatnonzero(keep))
