"""Host-side audio I/O, batch assembly and the device-resident eval cache."""
