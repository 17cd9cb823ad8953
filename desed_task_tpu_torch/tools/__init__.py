"""Offline tools of the recipes: embedding extraction, source separation of
dataset folders, soundscape synthesis (dsp, soundscapes), hyperparameter
search, the serving export, downloads and the dataset layout."""
