"""Spans and counters of the port's host work, on the profiler's clock.

A span names an interval of host work, `with span("eval.view", name):`.
While a `torch.profiler` records, it opens
`torch.profiler.record_function("glic." + name)`, a range in the same
trace as the kernels it launches (so on the device trace's clock: in a
traced benchmark window and in the CLI's `--profile` chrome trace), and
appends (name, id, parent, start, end) to the current record, with
`time.perf_counter_ns` endpoints. The `id` ties the spans of one unit of
work together: the frame id under `add_frame`, the view name under eval.
`count(name, n)` adds to a counter of the same record.

With no profiler recording, `span` makes the profiler check and returns a
shared no-op context: no `record_function`, no clock reading. Recording has
no other switch. `timed` is the one kind of span that reads the clock
either way: its seconds feed `MappingEngine.timers`, so that a timer and
its span are one measurement.

`sync(site, fn, *args)` makes a call that blocks the host until the
device's stream drains (a `.tolist()`, `float()` or `int()` of a device
tensor; `upload`, a pageable host-to-device copy): inside a span
`sync.<site>` it adds 1 to `host_syncs`; `upload` adds its bytes to
`h2d_bytes`. It calls `fn` as the caller would, so results are unchanged.
Counts are per call site, the same on the CPU as on the card.

A record holds one profiler session: the first span, count or sync that
sees a profiler recording, after one that saw none, starts a new record
(two sessions with no such call between them share one). So, off, they
also read one flag, which the first of them after a session clears: the
off path's one write. `record()` is the current or last record;
`Record.summary()` is what the CLI's `--profile` writes beside its trace.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, List, Optional

import torch

PREFIX = "glic."

_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One span of a record: its parent is the index in `Record.spans` of
    the span that was open when it began (-1 for none); times in ns."""

    __slots__ = ("name", "id", "parent", "start", "end")

    def __init__(self, name: str, id: Any, parent: int, start: int):
        self.name, self.id, self.parent, self.start, self.end = name, id, parent, start, start

    @property
    def ns(self) -> int:
        return self.end - self.start


class Record:
    """The spans (in the order they began) and counters of one session."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Counter = Counter()
        self._open: List[int] = []

    def inside(self, s: Span, name: str) -> bool:
        """Whether a span named `name` holds `s`."""
        while s.parent >= 0:
            s = self.spans[s.parent]
            if s.name == name:
                return True
        return False

    def _begin(self, name: str, id: Any, t: int) -> int:
        i = len(self.spans)
        self.spans.append(Span(name, id, self._open[-1] if self._open else -1, t))
        self._open.append(i)
        return i

    def _end(self, i: int, t: int) -> None:
        self.spans[i].end = t
        self._open.remove(i)

    def summary(self) -> dict:
        """The counters, and each span name's count and summed host ms."""
        by_name: dict = {}
        for s in self.spans:
            n, ms = by_name.get(s.name, (0, 0.0))
            by_name[s.name] = (n + 1, ms + s.ns * 1e-6)
        return {"counts": dict(self.counts),
                "spans": {k: {"n": n, "ms": ms} for k, (n, ms) in by_name.items()}}


class _State:
    __slots__ = ("live", "record")

    def __init__(self):
        self.live = False                  # the last span saw a profiler recording
        self.record: Optional[Record] = None


_STATE = _State()


def _current() -> Record:
    """The record of the recording session (a new one at its first span)."""
    if not _STATE.live:
        _STATE.live, _STATE.record = True, Record()
    return _STATE.record


def _off() -> bool:
    """True with no profiler recording (and the session, if any, closed)."""
    if _profiler_enabled():
        return False
    if _STATE.live:
        _STATE.live = False
    return True


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Recorded:
    """A span while a profiler records; its clock readings lie inside its
    profiler range. `timed` reads the end itself and passes it to `_close`."""

    __slots__ = ("name", "id", "_rec", "_i", "_rf")

    def __init__(self, name: str, id: Any):
        self.name, self.id = name, id

    def _open(self) -> int:
        self._rec = _current()
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        t = time.perf_counter_ns()
        self._i = self._rec._begin(self.name, self.id, t)
        return t

    def _close(self, t: Optional[int] = None) -> None:
        self._rec._end(self._i, time.perf_counter_ns() if t is None else t)
        self._rf.__exit__(None, None, None)

    def __enter__(self):
        self._open()
        return self

    def __exit__(self, *exc):
        self._close()
        return False


def span(name: str, id: Any = None):
    """A context over host work named `name` (recorded as "glic." + name)."""
    return _NOOP if _off() else _Recorded(name, id)


class timed:
    """A span that reads the clock with or without a profiler: after the
    block, `seconds` is its length, and the span's endpoints when a
    profiler records are the same two readings."""

    __slots__ = ("seconds", "_span", "_t0")

    def __init__(self, name: str, id: Any = None):
        self._span = None if _off() else _Recorded(name, id)
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter_ns() if self._span is None else self._span._open()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) * 1e-9
        if self._span is not None:
            self._span._close(t1)
        return False


def count(name: str, n: int = 1) -> None:
    """Adds `n` to counter `name` of the current record."""
    if not _off():
        _current().counts[name] += n


def sync(site: str, fn: Callable, *args, **kw):
    """`fn(*args, **kw)`, a call that waits for the device's stream, as
    the span `sync.<site>` that adds 1 to `host_syncs`."""
    return fn(*args, **kw) if _off() else _synced(site, fn, *args, **kw)


def _synced(site: str, fn: Callable, *args, **kw):
    with _Recorded("sync." + site, None):
        out = fn(*args, **kw)
        _STATE.record.counts["host_syncs"] += 1
    return out


def upload(x, **kw) -> torch.Tensor:
    """`torch.as_tensor(x, **kw)`; host data `x` (not a tensor) through
    `sync("upload")`, a pageable copy that waits for the stream, its
    bytes added to `h2d_bytes`."""
    if isinstance(x, torch.Tensor) or _off():
        return torch.as_tensor(x, **kw)
    out = _synced("upload", torch.as_tensor, x, **kw)
    _STATE.record.counts["h2d_bytes"] += out.nbytes
    return out


def record() -> Optional[Record]:
    """The current session's record, or the last one's; None before any."""
    return _STATE.record
