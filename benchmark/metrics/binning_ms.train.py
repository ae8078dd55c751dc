"""Device ms a step of K8, the sort, K9 and K10 (ops/tiles.py, ops/rasterize.py)."""

from harness import readers


def read(run):
    return readers.stage_ms_per(run, "binning", "steps")
