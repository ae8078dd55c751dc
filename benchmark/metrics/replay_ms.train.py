"""Host ms of CUDA graph launch a train step in the traced train window:
the program's `bundle.replay` spans (`graph.replay()` alone; the id is the
graph's step count), summed, over the steps they replay. The launch does
not wait for the card: on an H100 a replay takes the same host time a
step in both train cells, whose device time a step differs 1.7x, and a
16-step replay issued behind the 64-step graph's queued work returns in
a few ms. So this is the launch's own cost, which idles the card only
where it exceeds the device time of the steps it launches."""

from harness import spans


def read(run):
    rec = spans.record(run)
    replays = [s for s in rec.spans if s.name == "bundle.replay"] if rec is not None else []
    steps = sum(s.id for s in replays)
    return sum(s.ns for s in replays) * 1e-6 / steps if steps else None
