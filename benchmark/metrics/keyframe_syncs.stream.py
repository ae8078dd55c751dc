"""The program's `host_syncs` counter (calls that wait for the device's
stream) over the traced stream window's keyframes: a keyframe cycle's
uploads and fetches, in its ingests, its extend and its optimize()."""

from harness import spans


def read(run):
    rec, keyframes = spans.record(run), run.layer.get("keyframes")
    if rec is None or not keyframes or not any(s.name == "frame" for s in rec.spans):
        return None
    return rec.counts["host_syncs"] / keyframes
