"""The training engine: train state, one train step, the host loop."""
