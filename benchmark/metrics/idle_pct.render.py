"""The device's idle share of the traced eval window, in %."""

from harness import readers


def read(run):
    return readers.idle_pct(run)
