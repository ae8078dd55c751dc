"""Host ms a keyframe of the program's `frame.extend` spans (MappingEngine._extend:
the accumulated points padded and uploaded, the `no_color` render of the
newest keyframe, projection, per-pixel dedup and append, and the fetch of
the appended count) in the traced stream window, summed, over the window's
keyframes. The extend ends in that fetch, so its span holds its device
work."""

from harness import spans


def read(run):
    rec, keyframes = spans.record(run), run.layer.get("keyframes")
    ns = [s.ns for s in rec.spans if s.name == "frame.extend"] if rec is not None else []
    return sum(ns) * 1e-6 / keyframes if ns and keyframes else None
