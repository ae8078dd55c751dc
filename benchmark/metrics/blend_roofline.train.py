"""The blend stage's bound over K1 and K2's device time, in %."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "blend")
