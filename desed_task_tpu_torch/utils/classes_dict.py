"""DCASE Task 4 class vocabularies (own copy of the two label sets the 2024
recipe serves, from desed_task_tpu/utils/classes_dict.py)."""

from collections import OrderedDict

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
