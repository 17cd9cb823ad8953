"""Plain reference of the measured paths, independent of the program."""
