"""Host ms a view waits on the device in the traced eval window: the
program's `sync.*` spans inside its `eval.view` spans (the camera's and
target's uploads, the overflow counters' fetch) and each split's
`sync.split` fetch, summed, over the window's views."""

from harness import spans


def read(run):
    rec, views = spans.eval_views(run)
    if rec is None:
        return None
    split_ns = sum(s.ns for s in rec.spans if s.name == "sync.split")
    return (spans.sync_ns_in_views(rec) + split_ns) * 1e-6 / views
