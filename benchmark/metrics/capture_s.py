"""Seconds of the set-up's CUDA graph captures (BundleGraphs.captures)."""

from harness import readers


def read(run):
    return run.layer.get("capture_s")
