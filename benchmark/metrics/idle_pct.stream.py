"""The device's idle share of the traced stream window, in %."""

from harness import readers


def read(run):
    return readers.idle_pct(run) if run.layer.get("frames") else None
