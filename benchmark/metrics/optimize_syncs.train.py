"""The program's `host_syncs` counter (calls that wait for the device's
stream) over its `optimize` spans, one per optimize() call, in the traced
train window."""

from harness import spans


def read(run):
    rec = spans.record(run)
    if rec is None or "host_syncs" not in rec.counts:
        return None
    calls = sum(s.name == "optimize" for s in rec.spans)
    return rec.counts["host_syncs"] / calls if calls else None
