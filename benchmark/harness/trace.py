"""The traced run's reading of a `torch.profiler` trace: device time by
owner, the union of the device's intervals, the host spans the benchmark
records around its calls into the program, and the longest idle gaps with
the span that the host was in.

Spans are `torch.profiler.record_function` ranges named `bench.<what>`,
opened by the benchmark's own code (no span lives inside the program).
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

from harness.owners import busy_intervals, owner

SPAN_PREFIX = "bench."


def span(name: str):
    """A host span around a call into the program: a profiler range when a
    trace records, else nothing."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields the profiler (None when not tracing) around the traced window."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
    torch.cuda.synchronize()


def read(prof, window_s: float) -> dict:
    """What the per-layer readers take from a trace of a window of
    `window_s` host seconds: seconds by owner and by kernel name, the
    device's busy seconds, and the 10 longest idle gaps by host span."""
    import torch

    dev: List[Tuple[float, float]] = []
    by_owner: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    spans: List[Tuple[float, float, str]] = []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or end <= start:
                continue
            dev.append((start, end))
            by_owner[owner(e.name)] += (end - start) * 1e-6
            by_name[e.name] += (end - start) * 1e-6
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((start, end, e.name[len(SPAN_PREFIX):]))
    merged = busy_intervals(dev)
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        inside = [s for s in spans if s[0] <= mid <= s[1]]
        # the innermost span that holds the gap's middle
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "outside spans"
        gaps.append((name, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return dict(owner_s=dict(by_owner), busy_s=busy_s, window_s=window_s,
                device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                idle_gaps=gaps[:10])
