"""Run records: metrics log, checkpoints, energy estimate, MACs, stall
watchdog, profiling (a Chrome trace, a step timer)."""
