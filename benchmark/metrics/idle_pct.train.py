"""The device's idle share of the traced train window, in %."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
