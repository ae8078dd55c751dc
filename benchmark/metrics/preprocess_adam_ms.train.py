"""Device ms a step of K5, K6 and K7 (ops/preprocess.py, ops/adam.py)."""

from harness import readers


def read(run):
    return readers.stage_ms_per(run, "preprocess_adam", "steps")
