"""Host-side audio I/O."""
