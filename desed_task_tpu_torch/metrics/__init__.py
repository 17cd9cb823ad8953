"""DCASE metrics: PSDS, intersection and collar F1, segment metrics."""
