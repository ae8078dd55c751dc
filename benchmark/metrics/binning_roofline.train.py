"""The binning stage's bound over K8, the sort, K9 and K10's device time, in %."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "binning")
