"""Port parity: stream ingest — the +-10 ms aligner (Python and native), the
watchdog, RecordedStream directories, the rosbag reader and the live TCPROS
subscriber — against the JAX package, on the same scripted inputs and the
`tests/ros_wire.py` fixtures.

Tolerances: every aligner decision, frame and array exact.
"""

import numpy as np
import pytest
from ros_wire import mk_frames
from test_ros_live import FakeGraph, _messages
from test_rosbag import _write_bag

from gaussian_lic_tpu.engine import stream as jstream
from gaussian_lic_tpu.engine.dataset import FrameInput as JFrame
from gaussian_lic_tpu.io import rosbag as jrosbag
from gaussian_lic_tpu_torch.engine import stream as tstream
from gaussian_lic_tpu_torch.engine.dataset import FrameInput
from gaussian_lic_tpu_torch.io import ros_live, rosbag

FRAME_FIELDS = ("R_wc", "t_wc", "image", "points", "colors")


def scripted_events(seed, n=40):
    """n point/pose/image triplets 50 ms apart, each message jittered
    N(0, 6 ms) (so some miss the +-10 ms window), pushed in a random order,
    one in ten left out."""
    rng = np.random.default_rng(seed)
    events = []
    for k in range(n):
        for kind in rng.permutation(["points", "pose", "image"]):
            if rng.uniform() < 0.9:
                events.append((str(kind), 0.05 * k + float(rng.normal(0, 0.006)), f"{kind}{k}"))
    return events


def decisions(aligner, events):
    """The aligner's answer after every push, then drained."""
    out = []
    for kind, stamp, payload in events:
        if kind == "points":
            aligner.push_points(stamp, payload, wall_time=0.0)
        else:
            getattr(aligner, f"push_{kind}")(stamp, payload)
        out.append(aligner.pop_aligned())
    for _ in range(len(events)):
        out.append(aligner.pop_aligned())
    return out


def make(kind):
    return tstream.NativeStreamAligner(0.01) if kind == "native" else tstream.StreamAligner(0.01)


class TestAligner:
    @pytest.mark.parametrize("kind", ["python", "native"])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_decisions_equal_jax(self, kind, seed):
        events = scripted_events(seed)
        got = decisions(make(kind), events)
        want = decisions(jstream.StreamAligner(0.01), events)
        assert got == want
        assert sum(g is not None for g in got) >= 5

    @pytest.mark.parametrize("kind", ["python", "native"])
    def test_reference_cases(self, kind):
        """Exact and within-tolerance triplets align; stale poses/images go;
        an unmatched point cloud is dropped (mapping.cpp:64-122)."""
        events = [
            ("points", 1.000, "p1"), ("pose", 1.009, "T1"), ("image", 0.992, "I1"),
            ("points", 2.0, "p2"), ("pose", 1.5, "T_old"), ("pose", 2.0, "T2"),
            ("image", 1.7, "I_old"), ("image", 2.0, "I2"),
            ("points", 3.0, "p3"), ("points", 4.0, "p4"), ("pose", 4.0, "T4"),
            ("image", 4.0, "I4"),
        ]
        got = [g for g in decisions(make(kind), events) if g is not None]
        assert got == [(1.0, "p1", "T1", "I1"), (2.0, "p2", "T2", "I2"),
                       (4.0, "p4", "T4", "I4")]
        assert got == [g for g in decisions(jstream.StreamAligner(0.01), events)
                       if g is not None]

    def test_make_aligner(self, monkeypatch):
        assert isinstance(tstream.make_aligner(), tstream.NativeStreamAligner)
        assert isinstance(tstream.make_aligner(prefer_native=False), tstream.StreamAligner)
        monkeypatch.setenv("GLIC_DISABLE_NATIVE", "1")
        assert type(tstream.make_aligner()) is tstream.StreamAligner

    def test_watchdog(self):
        for mod in (tstream, jstream):
            a, w = mod.StreamAligner(), mod.Watchdog(timeout=1.0)
            a.push_points(0.0, "p", wall_time=100.0)
            assert not w.expired(a, now=200.0)
            w.initialized = True
            assert w.expired(a, now=101.5) and not w.expired(a, now=100.5)


def seeded_frames(rng, cls, n=3):
    return [cls(timestamp=0.1 * i, R_wc=np.eye(3, dtype=np.float32),
                t_wc=np.asarray([0.0, 0.0, float(i)], np.float32),
                image=rng.integers(0, 255, (8, 16, 3), dtype=np.uint8),
                points=rng.normal(size=(20, 3)).astype(np.float32),
                colors=rng.uniform(size=(20, 3)).astype(np.float32))
            for i in range(n)]


def assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.timestamp == w.timestamp
        for f in FRAME_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                          err_msg=f)


class TestRecordedStream:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_written_by_one_read_by_the_other(self, tmp_path, rng, writer):
        w_mod, r_mod, cls = ((tstream, jstream, FrameInput) if writer == "port"
                             else (jstream, tstream, JFrame))
        frames = seeded_frames(rng, cls)
        for i, f in enumerate(frames):
            w_mod.RecordedStream.write_frame(str(tmp_path), i, f)
        got = list(r_mod.RecordedStream(str(tmp_path)))
        assert_frames_equal(got, frames)
        assert_frames_equal(list(w_mod.RecordedStream(str(tmp_path))), got)

    def test_empty_directory(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            tstream.RecordedStream(str(tmp_path))


class TestRosbag:
    @pytest.mark.parametrize("chunked,comp", [(False, "none"), (True, "bz2")])
    def test_frames_equal_jax(self, tmp_path, rng, chunked, comp):
        frames = mk_frames(rng, n=4)
        bag = str(tmp_path / "t.bag")
        _write_bag(bag, frames, chunked=chunked, compression=comp)
        got = list(rosbag.RosbagStream(bag))
        assert all(isinstance(f, FrameInput) for f in got)
        assert_frames_equal(got, list(jrosbag.RosbagStream(bag)))
        for fi, (stamp, pts, _c, t, _q, img) in zip(got, frames):
            assert abs(fi.timestamp - stamp) < 1e-6
            np.testing.assert_array_equal(fi.image, img)

    def test_not_a_bag(self, tmp_path):
        p = tmp_path / "x.bag"
        p.write_bytes(b"hello world")
        with pytest.raises(ValueError):
            list(rosbag.RosbagStream(str(p)))


class TestRosLive:
    def test_live_roundtrip(self, rng):
        frames = mk_frames(rng, n=3)
        graph = FakeGraph(_messages(frames))
        try:
            out = list(ros_live.RosLiveStream(master_uri=graph.master_uri, idle_timeout=1.0))
            assert graph.subscriber_uris == {}   # unregistered on stop
        finally:
            graph.close()
        assert len(out) == len(frames)
        for fi, (stamp, pts, cols, t, _q, img) in zip(out, frames):
            assert isinstance(fi, FrameInput)
            assert abs(fi.timestamp - stamp) < 1e-6
            np.testing.assert_allclose(fi.points, pts, rtol=1e-6)
            np.testing.assert_allclose(fi.colors, cols, atol=1 / 255 + 1e-3)
            np.testing.assert_allclose(fi.t_wc, t, rtol=1e-6)
            np.testing.assert_array_equal(fi.image, img)

    def test_rejected_handshake_yields_nothing(self, rng):
        graph = FakeGraph(_messages(mk_frames(rng, n=2)), reject_header=True)
        try:
            assert list(ros_live.RosLiveStream(master_uri=graph.master_uri,
                                               idle_timeout=0.5)) == []
        finally:
            graph.close()
