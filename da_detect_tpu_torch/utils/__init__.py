"""Utilities: weight bridging from the JAX package's variables."""
