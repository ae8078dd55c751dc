"""Arithmetic the per-layer readers (benchmark/metrics/<name>.py) share.
Each returns None where the run holds nothing to read."""

from __future__ import annotations

from harness.owners import STAGES


def stage_s(run, stage: str):
    """Device seconds of a stage's owners in the traced window."""
    t = run.layer.get("trace")
    if t is None:
        return None
    s = sum(t["owner_s"].get(o, 0.0) for o in STAGES[stage])
    return s if s > 0 else None


def stage_ms_per(run, stage: str, per: str):
    """Device ms of a stage per step (`per` "steps") or per view ("views")."""
    s, n = stage_s(run, stage), run.layer.get(per)
    return None if s is None or not n else s / n * 1e3


def roofline_pct(run, stage: str):
    """The stage's bound over its device time per step, in %."""
    b = run.layer.get("bounds_s")
    ms = stage_ms_per(run, stage, "steps")
    return None if b is None or ms is None else b[stage] * 1e3 / ms * 100.0


def step_mfu_pct(run):
    """The step's summed stage bounds over the host-measured time of a step."""
    b, t = run.layer.get("bounds_s"), run.layer.get("trace")
    n = run.layer.get("steps")
    if b is None or t is None or not n:
        return None
    return b["step"] / (t["window_s"] / n) * 100.0


def idle_pct(run):
    t = run.layer.get("trace")
    if t is None or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
