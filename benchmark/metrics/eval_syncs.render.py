"""The program's `host_syncs` counter (calls that wait for the device's
stream) over the traced eval window's views."""

from harness import spans


def read(run):
    rec, views = spans.eval_views(run)
    if rec is None or "host_syncs" not in rec.counts:
        return None
    return rec.counts["host_syncs"] / views
