"""The general generators of the traffic kinds: train steps and eval passes."""
