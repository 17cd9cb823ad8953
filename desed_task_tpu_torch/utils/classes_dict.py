"""DCASE Task 4 class vocabularies and the MAESTRO -> DESED aliases (own copy
of desed_task_tpu/utils/classes_dict.py; `process_tsvs` works on column
tables, utils/table.py)."""

from collections import OrderedDict

import numpy as np

CLASSES_DESED = OrderedDict(
    (name, i)
    for i, name in enumerate(
        [
            "Alarm_bell_ringing",
            "Blender",
            "Cat",
            "Dishes",
            "Dog",
            "Electric_shaver_toothbrush",
            "Frying",
            "Running_water",
            "Speech",
            "Vacuum_cleaner",
        ]
    )
)

CLASSES_MAESTRO_REAL = OrderedDict(
    (name, i)
    for i, name in enumerate(
        [
            "cutlery and dishes",
            "furniture dragging",
            "people talking",
            "children voices",
            "coffee machine",
            "footsteps",
            "large_vehicle",
            "car",
            "brakes_squeaking",
            "cash register beeping",
            "announcement",
            "shopping cart",
            "metro leaving",
            "metro approaching",
            "door opens/closes",
            "wind_blowing",
            "birds_singing",
        ]
    )
)

CLASSES_MAESTRO_SYNTH = OrderedDict(
    (name, i)
    for i, name in enumerate(
        [
            "car_horn",
            "children_voices",
            "engine_idling",
            "siren",
            "street_music",
            "dog_bark",
        ]
    )
)

# 11-class MAESTRO evaluation subset
CLASSES_MAESTRO_REAL_EVAL = {
    "birds_singing",
    "car",
    "people talking",
    "footsteps",
    "children voices",
    "wind_blowing",
    "brakes_squeaking",
    "large_vehicle",
    "cutlery and dishes",
    "metro approaching",
    "metro leaving",
}

# MAESTRO -> DESED label aliases for cross-dataset event duplication
MAESTRO_DESED_ALIAS = {
    "people talking": "Speech",
    "children voices": "Speech",
    "announcement": "Speech",
    "cutlery and dishes": "Dishes",
    "dog_bark": "Dog",
}


def process_tsvs(tsv, alias_map=MAESTRO_DESED_ALIAS) -> dict:
    """Duplicate aliased events under their DESED names (local/utils.py:18-31):
    each row whose label has an alias is appended again, after all rows,
    with the alias as its label, so both class columns receive supervision.
    Takes a column table (or a DataFrame); returns a column table."""
    from . import table as tbl

    t = tbl.as_columns(tsv)
    rows = np.flatnonzero([lab in alias_map for lab in t["event_label"]])
    extra = tbl.take(t, rows)
    extra["event_label"] = np.asarray([alias_map[lab] for lab in extra["event_label"]],
                                      dtype=object)
    return {c: np.concatenate([t[c], extra[c]]) for c in t}
