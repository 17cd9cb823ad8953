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
