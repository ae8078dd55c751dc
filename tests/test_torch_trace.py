"""The port's spans and counters (gaussian_lic_tpu_torch/utils/trace.py).

Off, a span opens no profiler range, reads no clock and records nothing.
Under `torch.profiler.profile` the spans are `glic.*` ranges of the
profiler's own trace, nested as called, and a record of their names, ids
and parents; a new session starts a new record. On a tiny CPU stream: the
eval's views and blocking calls, one optimize() call's bundles and fetches
and the extend's added count, exact by call site; the engine's timers are
the `frame.*` spans' own clock readings. On the card: the counters miss
none of the synchronising calls that CUDA's sync debug mode reports.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import cuda_device  # noqa: F401  (fixture)

from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.evaluate import evaluate_visual_quality
from gaussian_lic_tpu_torch.engine.trainer import MappingEngine, PhaseTimers, _decompose_bundles
from gaussian_lic_tpu_torch.utils import trace

CFG = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0, skybox_points_num=0,
             initial_capacity=512, densify_budget=256, max_train_keyframes=4,
             max_iters_per_keyframe=5, opt_bundle_sizes=(4, 1), select_every_k_frame=3)
N_FRAMES = 6          # keyframes 2 and 5; frames 0, 1, 3, 4 held out


@contextlib.contextmanager
def recording():
    """A profiler session with a record of its own: a span that sees no
    profiler closes the last session's record first (the module's rule)."""
    with trace.span("unrecorded"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def frames():
    from gaussian_lic_tpu_torch.camera import Intrinsics
    from gaussian_lic_tpu_torch.utils.synthetic import make_sequence, make_world

    rng = np.random.default_rng(5)
    intr = Intrinsics(width=CFG.width, height=CFG.height, fx=CFG.fx, fy=CFG.fy, cx=CFG.cx,
                      cy=CFG.cy)
    return make_sequence(make_world(rng, n_points=300, intr=intr), n_frames=N_FRAMES,
                         points_per_frame=120, rng=rng)


def names(rec):
    return [s.name for s in rec.spans]


@pytest.fixture(scope="module")
def stream():
    """A CPU engine fed the 6 frames, the last keyframe's 3 frames under the
    profiler: (engine, that session's record, the count before them)."""
    eng, fs = MappingEngine(CFG, device="cpu"), frames()
    for f in fs[:3]:
        eng.add_frame(f)
    before = int(eng.gm.count)
    with recording():
        for f in fs[3:]:
            eng.add_frame(f)
    return eng, trace.record(), before


def test_off_path_opens_no_range_reads_no_clock_and_records_nothing(monkeypatch):
    with recording():
        with trace.span("before"):
            pass
    rec = trace.record()
    n_spans, counts = len(rec.spans), dict(rec.counts)

    def refuse(*a, **k):
        raise AssertionError("called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(time, "perf_counter_ns", refuse)
    monkeypatch.setattr(time, "perf_counter", refuse)
    with trace.span("off", 3):
        with trace.span("inner"):
            trace.count("things", 2)
            assert trace.sync("site", int, torch.tensor(4)) == 4
            up = trace.upload(np.arange(3, dtype=np.float32), dtype=torch.float32)
    assert torch.equal(up, torch.arange(3, dtype=torch.float32))
    assert trace.record() is rec and len(rec.spans) == n_spans and dict(rec.counts) == counts


def test_timed_reads_the_clock_either_way_and_records_only_under_a_profiler(monkeypatch):
    with trace.timed("frame.ingest") as t:
        time.sleep(0.002)
    assert t.seconds >= 0.002
    with recording():
        with trace.timed("frame.ingest", 9) as t:
            time.sleep(0.002)
    (s,) = trace.record().spans
    assert (s.name, s.id) == ("frame.ingest", 9) and s.ns * 1e-9 == t.seconds


def test_spans_are_profiler_ranges_nested_as_called_with_ids():
    with recording() as prof:
        with trace.span("outer", "view_7"):
            with trace.span("inner", "view_7"):
                trace.sync("fetch", float, torch.tensor(2.5))
            with trace.span("second"):
                trace.count("things", 3)
    rec = trace.record()
    assert names(rec) == ["outer", "inner", "sync.fetch", "second"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0]
    assert [s.id for s in rec.spans] == ["view_7", "view_7", None, None]
    assert rec.counts == {"things": 3, "host_syncs": 1}
    assert rec.inside(rec.spans[2], "outer") and not rec.inside(rec.spans[0], "outer")
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith(trace.PREFIX)}
    assert set(ranges) == {"glic.outer", "glic.inner", "glic.sync.fetch", "glic.second"}
    for child, parent in (("inner", "outer"), ("sync.fetch", "inner"), ("second", "outer")):
        c, p = ranges["glic." + child], ranges["glic." + parent]
        assert p.start <= c.start and c.end <= p.end


def test_the_summary_counts_each_span_name_and_sums_its_host_ms():
    with recording():
        for _ in range(2):
            with trace.span("outer"):
                trace.sync("fetch", float, torch.tensor(1.0))
        trace.count("things", 4)
    rec = trace.record()
    outer = [s.ns * 1e-6 for s in rec.spans if s.name == "outer"]
    fetch = [s.ns * 1e-6 for s in rec.spans if s.name == "sync.fetch"]
    assert rec.summary() == {"counts": {"host_syncs": 2, "things": 4},
                             "spans": {"outer": {"n": 2, "ms": outer[0] + outer[1]},
                                       "sync.fetch": {"n": 2, "ms": fetch[0] + fetch[1]}}}


def test_a_new_session_starts_a_new_record():
    """After a span that saw no profiler; back to back, without one, the
    two sessions share a record."""
    with recording():
        with trace.span("first"):
            trace.count("n")
    first = trace.record()
    with trace.span("between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("second"):
            pass
    second = trace.record()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("n")
    assert second is not first and trace.record() is second
    assert names(first) == ["first"] and first.counts == {"n": 1}
    assert names(second) == ["second"] and second.counts == {"n": 1}


def test_eval_views_and_host_syncs_by_call_site(stream):
    """A keyframe view blocks once (its overflow counters), a held-out view
    six times (R, t and P of its camera, the view matrix's scalar store, its
    target, its counters), each split once more."""
    eng = stream[0]
    n_kf, n_ho = len(eng._kf_names), len(eng.test_cameras)
    assert (n_kf, n_ho) == (2, 4)
    with recording():
        res = evaluate_visual_quality(eng, save_images=False)
    rec = trace.record()
    assert np.isfinite(res["train_psnr"]) and np.isfinite(res["test_psnr"])
    views = [s for s in rec.spans if s.name == "eval.view"]
    assert [s.id for s in views] == eng._kf_names + [c.name for c in eng.test_cameras]
    by_name = {n: names(rec).count(n) for n in set(names(rec))}
    rerenders = rec.counts["eval.rerenders"]
    assert by_name == {"eval.view": 6, "eval.inputs": 6, "eval.render": 6 + rerenders,
                       "sync.overflow": 6 + rerenders, "eval.score": 6, "sync.upload": 5 * n_ho,
                       "sync.split": 2}
    assert rec.counts["host_syncs"] == n_kf * 1 + n_ho * 6 + 2 + 2 * rerenders
    assert rec.counts["h2d_bytes"] == n_ho * (9 * 4 + 3 * 4 + 16 * 4 + CFG.height * CFG.width * 3)
    for s in rec.spans:
        if s.name != "eval.view" and s.name != "sync.split":
            assert rec.inside(s, "eval.view"), s.name


def test_one_optimize_call_draws_runs_its_bundles_and_fetches_twice(stream):
    eng = stream[0]
    with recording():
        eng.optimize()
    rec = trace.record()
    bundles = _decompose_bundles(min(eng.kf_count, CFG.max_iters_per_keyframe),
                                 CFG.opt_bundle_sizes)
    assert names(rec).count("optimize") == 1 and rec.spans[0].id == eng.kf_count
    assert [s.id for s in rec.spans if s.name == "bundle"] == bundles
    assert names(rec).count("optimize.draw") == 1 and names(rec).count("sync.fetch") == 2
    assert rec.counts["host_syncs"] == 3 and rec.counts["h2d_bytes"] == 8 * eng.kf_count
    # the CPU runs the eager steps: no graph to replay
    assert "bundle.replay" not in names(rec) and rec.counts["bundle.replays"] == 0


def test_optimize_counts_the_rows_sparse_adam_updates(stream):
    """`adam.updated_rows` is the visible rows summed over the call's steps
    (from the fetch optimize() makes anyway), `adam.rows` the steps times
    the map's rows: their ratio is the share of rows K7 touches."""
    eng = stream[0]
    with recording():
        mean = eng.optimize()
    rec = trace.record()
    steps = min(eng.kf_count, CFG.max_iters_per_keyframe)
    assert rec.counts["adam.rows"] == steps * eng.gm.capacity
    assert rec.counts["adam.updated_rows"] == round(mean * steps)
    assert 0 < rec.counts["adam.updated_rows"] <= steps * int(eng.gm.count)
    assert rec.counts["host_syncs"] == 3


def test_the_extend_counts_the_gaussians_it_adds(stream):
    eng, rec, before = stream
    frames_ = [s for s in rec.spans if s.name == "frame"]
    assert [s.id for s in frames_] == [3, 4, 5]
    assert names(rec).count("frame.extend") == 1 and names(rec).count("frame.optimize") == 1
    assert rec.counts["extend.added"] == int(eng.gm.count) - before > 0
    assert rec.counts["extend.candidates"] >= rec.counts["extend.added"]
    for n in ("extend.upload", "extend.render"):
        (s,) = [s for s in rec.spans if s.name == n]
        assert rec.inside(s, "frame.extend")
    # held-out frames block nowhere; the keyframe's ingest five times (R, t,
    # P, the view matrix's scalar, image), its extend six (four uploads, the
    # map's count, the added count), its optimize() three (the ids, two
    # fetches)
    assert names(rec).count("sync.extend_count") == 2
    assert rec.counts["host_syncs"] == 5 + 6 + 3


def test_the_timers_are_the_frame_spans_clock_readings(stream):
    eng, rec, _ = stream
    t = eng.timers
    assert t.adding > 0 and t.extending > 0 and t.optimize_steps > 0
    assert not hasattr(PhaseTimers(), "total_mapping")
    ext = [s.ns * 1e-9 for s in rec.spans if s.name == "frame.extend"]
    assert t.extending == pytest.approx(sum(ext), rel=1e-12, abs=1e-15)


@pytest.mark.requires_cuda
def test_the_counters_miss_no_sync_on_the_card(cuda_device):  # noqa: F811
    """host_syncs of one evaluate_visual_quality call and of one optimize()
    call equal the synchronising calls CUDA's sync debug mode reports."""
    eng = MappingEngine(CFG, device=cuda_device)
    for f in frames():
        eng.add_frame(f)
    evaluate_visual_quality(eng, save_images=False)
    eng.optimize()
    torch.cuda.synchronize()

    def syncs(fn):
        with recording(), warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # switching the mode back off warns once, from torch's own frame
        own = os.path.join("torch", "cuda", "__init__.py")
        return ([(w.filename, w.lineno) for w in seen
                 if "synchroniz" in str(w.message) and not w.filename.endswith(own)],
                trace.record().counts)

    for fn in (lambda: evaluate_visual_quality(eng, save_images=False), eng.optimize):
        warned, counts = syncs(fn)
        assert counts["host_syncs"] == len(warned) > 0, warned
