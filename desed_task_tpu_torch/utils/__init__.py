"""Label vocabularies and column tables."""
