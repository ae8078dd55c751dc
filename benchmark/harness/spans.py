"""The program's own spans and counters (gaussian_lic_tpu_torch/utils/trace.py)
as the per-layer readers take them: the record of the traced window's
profiler session. A program without that module has none to read."""

from __future__ import annotations


def record(run):
    """The traced window's record, or None (an untraced run, or no spans)."""
    if run.layer.get("trace") is None:
        return None
    try:
        from gaussian_lic_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.record()


def eval_views(run):
    """(record, the window's views) where the record holds `eval.view`
    spans, else (None, None)."""
    rec, views = record(run), run.layer.get("views")
    if rec is None or not views or not any(s.name == "eval.view" for s in rec.spans):
        return None, None
    return rec, views


def sync_ns_in_views(rec) -> int:
    """Host ns of the `sync.*` spans inside `eval.view` spans."""
    return sum(s.ns for s in rec.spans
               if s.name.startswith("sync.") and rec.inside(s, "eval.view"))
