"""Deterministic synthetic training data (numpy, no JAX)."""
