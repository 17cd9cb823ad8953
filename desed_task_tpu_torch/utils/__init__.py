"""Label vocabularies."""
