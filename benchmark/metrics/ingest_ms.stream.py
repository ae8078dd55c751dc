"""Host ms a frame of the program's `frame.ingest` spans (MappingEngine._ingest:
the frame's points into the accumulator, then a held-out view kept on the
host or the keyframe's camera and image uploaded) in the traced stream
window, summed, over the window's frames."""

from harness import spans


def read(run):
    rec, frames = spans.record(run), run.layer.get("frames")
    ns = [s.ns for s in rec.spans if s.name == "frame.ingest"] if rec is not None else []
    return sum(ns) * 1e-6 / frames if ns and frames else None
