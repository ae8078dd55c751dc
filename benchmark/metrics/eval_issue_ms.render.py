"""Host ms a view spends issuing work in the traced eval window: the
program's `eval.view` spans less their `sync.*` spans, summed, over the
window's views."""

from harness import spans


def read(run):
    rec, views = spans.eval_views(run)
    if rec is None:
        return None
    view_ns = sum(s.ns for s in rec.spans if s.name == "eval.view")
    return (view_ns - spans.sync_ns_in_views(rec)) * 1e-6 / views
