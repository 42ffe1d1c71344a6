"""Observability: the port's copy of the jax-free ``obs/metrics.py``."""
