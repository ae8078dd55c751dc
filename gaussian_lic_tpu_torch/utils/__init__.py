"""Synthetic sequences for tests and benchmarks."""
