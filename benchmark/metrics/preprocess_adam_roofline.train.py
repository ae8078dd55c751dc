"""The preprocess and Adam stage's bound over K5, K6 and K7's device time, in %."""

from harness import readers


def read(run):
    return readers.roofline_pct(run, "preprocess_adam")
