"""Serving pipeline, decoding, MAESTRO scoring and score files."""
