"""Front-end, normalization, post-processing and the hand-written kernels."""
