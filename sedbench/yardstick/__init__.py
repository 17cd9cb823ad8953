"""What the benchmark measures against: analytic work, peaks, least times."""
