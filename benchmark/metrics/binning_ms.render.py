"""Device ms a view of K8, the sort, K9 and K10 on the eval path."""

from harness import readers


def read(run):
    return readers.stage_ms_per(run, "binning", "views")
