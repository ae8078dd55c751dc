"""Device ms a step of K1 and K2 (ops/blend.py)."""

from harness import readers


def read(run):
    return readers.stage_ms_per(run, "blend", "steps")
