"""Run records: metrics log, checkpoints, energy estimate, MACs, stall watchdog."""
