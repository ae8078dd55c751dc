"""The train step's stage bounds summed (computed from the counts of the
window's starting state), over the host-clock time of a step in the traced
window, in %."""

from harness import readers


def read(run):
    return readers.step_mfu_pct(run)
