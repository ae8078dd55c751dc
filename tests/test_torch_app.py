"""Port parity: the end of a run and the application — MappingEngine.finalize
(eval with LPIPS, PLY) against the JAX engine's on a 9-frame stream with a
skybox (the `finalize` golden of tools/make_torch_goldens.py; `live` re-runs
the JAX side in interpret mode, minutes), measure_phase_split, and the CLI
(`python -m gaussian_lic_tpu_torch`) on the CPU.

Tolerance of finalize: every eval metric within 1e-4 relative (measured
1.0e-5 at most, test SSIM), the Gaussian count and the PLY header exact; of
each PLY array at least 95% of entries within 1e-4, a median gap under 1e-6
and no gap over 1e-2 (measured largest: quat 4.1e-3, log_scale 2.5e-3, dc
3.2e-4). Both engines start from the same skybox (JAX's uniforms
substituted) and keyframe order; float32 summation order separates their
train steps, and sparse Adam without bias correction moves an entry whose
gradient is float noise by ~lr per flipped sign (test_torch_train.py).
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import GOLDEN_SOURCES, frames_from, golden_tool, load_golden, t

from gaussian_lic_tpu_torch import run
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.dataset import FrameInput
from gaussian_lic_tpu_torch.engine.stream import RecordedStream, Watchdog
from gaussian_lic_tpu_torch.engine.trainer import MappingEngine, PhaseTimers
from gaussian_lic_tpu_torch.io import checkpoint, ply
from gaussian_lic_tpu_torch.models import gaussians

RESULT_RTOL = 1e-4


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def finalize_golden(request):
    return load_golden("finalize", request.param)


def ply_header(data: bytes) -> bytes:
    return data[: data.index(b"end_header\n")]


class TestFinalize:
    def test_against_jax(self, finalize_golden, tmp_path, monkeypatch):
        d = finalize_golden
        tool = golden_tool()
        jcfg = tool.finalize_params()
        cfg = Params(**{f: getattr(jcfg, f) for f in Params.__dataclass_fields__})
        monkeypatch.setattr(gaussians, "skybox_uniforms",
                            lambda num, gen: (t(d["skybox_u1"]), t(d["skybox_u2"])))
        eng = MappingEngine(cfg, result_path=str(tmp_path), lpips_path="randinit",
                            device="cpu")
        for f in frames_from(d):
            eng.add_frame(f)
        res = eng.finalize()
        assert eng.kf_count == int(d["kf_count"]) == 3 and len(eng.test_cameras) == 6
        want = dict(zip(tool.RESULT_KEYS, d["results"]))
        assert res["num_gaussians"] == want["num_gaussians"]
        for k in tool.RESULT_KEYS:
            assert abs(res[k] - want[k]) <= RESULT_RTOL * abs(want[k]), k

        got_ply = (tmp_path / "point_cloud.ply").read_bytes()
        want_ply = d["ply"].tobytes()
        assert ply_header(got_ply) == ply_header(want_ply)
        want_path = tmp_path / "jax.ply"
        want_path.write_bytes(want_ply)
        a, b = ply.load_ply(str(tmp_path / "point_cloud.ply")), ply.load_ply(str(want_path))
        assert a["xyz"].shape[0] == int(res["num_gaussians"]) - cfg.skybox_points_num
        for k in a:
            gap = np.abs(a[k] - b[k])
            assert np.mean(gap <= 1e-4) >= 0.95 and np.median(gap) <= 1e-6, k
            assert gap.max() <= 1e-2, k
        for sub in ("render", "gt"):
            assert sorted(os.listdir(tmp_path / sub)) == sorted(
                [f"{n}.png" for n in eng._kf_names] + [c.name + ".png" for c in eng.test_cameras])


class TestPhaseSplit:
    def test_cpu_split(self, capsys):
        d = load_golden("engine", "file")
        tool = golden_tool()
        jcfg = tool.small_params()
        eng = MappingEngine(Params(**{f: getattr(jcfg, f) for f in Params.__dataclass_fields__}),
                            device="cpu")
        for f in frames_from(d)[:2]:
            eng.add_frame(f)
        split = eng.measure_phase_split(iters=1)
        assert set(split) == {"forward_ms", "backward_ms", "optimizer_ms", "whole_step_ms"}
        assert split["forward_ms"] > 0 and all(v >= 0 for v in split.values())
        assert split["whole_step_ms"] >= split["forward_ms"]
        assert "per-phase step split" in capsys.readouterr().out


class TestCli:
    def test_demo_writes_outputs_and_resumes(self, tmp_path, capsys):
        out, ckpt, prof = tmp_path / "out", tmp_path / "ckpt.npz", tmp_path / "prof"
        common = ["--demo", "--device", "cpu", "--demo-frames", "5", "--max-iters", "1"]
        assert run.main(common + ["--result-path", str(out), "--checkpoint", str(ckpt),
                                  "--lpips-path", "randinit", "--profile", str(prof)]) == 0
        text = capsys.readouterr().out
        assert "aligner: native" in text and "===== quality" in text
        with open(prof / "trace.json") as f:
            ranges = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {"glic.frame", "glic.frame.ingest", "glic.frame.initialize", "glic.frame.optimize",
                "glic.optimize", "glic.bundle", "glic.sync.upload", "glic.sync.fetch",
                "glic.eval.view", "glic.eval.render", "glic.sync.split"} <= ranges
        with open(prof / "record.json") as f:
            rec = json.load(f)
        assert rec["counts"]["host_syncs"] == sum(
            v["n"] for k, v in rec["spans"].items() if k.startswith("sync."))
        assert rec["spans"]["frame"]["n"] == 5 and rec["spans"]["frame"]["ms"] > 0
        m = ply.load_ply(str(out / "point_cloud.ply"))
        gm, opt, extra = checkpoint.load_checkpoint(str(ckpt), device="cpu")
        assert m["xyz"].shape[0] == int(gm.count) > 100 and int(extra["kf_count"]) == 1
        np.testing.assert_array_equal(m["xyz"], gm.xyz[: int(gm.count)].numpy())
        assert sorted(opt) == sorted(gm.trainable())
        views = sorted(["train_0004.png"] + [f"test_{i:04d}.png" for i in range(4)])
        assert sorted(os.listdir(out / "render")) == sorted(os.listdir(out / "gt")) == views

        assert run.main(common + ["--resume", str(ckpt), "--no-aligner", "--quiet",
                                  "--checkpoint", str(tmp_path / "c2.npz")]) == 0
        text = capsys.readouterr().out
        assert f"resumed from {ckpt}: {int(gm.count)} gaussians" in text
        assert "aligner: none" in text and "===== runtime stats" in text
        assert "[frame" not in text
        gm2, _, _ = checkpoint.load_checkpoint(str(tmp_path / "c2.npz"), device="cpu")
        assert int(gm2.count) >= int(gm.count)

    def test_no_cuda_exits_nonzero(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert run.main(["--demo"]) != 0
        assert "--device cpu" in capsys.readouterr().err

    def test_mesh_devices_not_ported(self, monkeypatch, capsys):
        """What --mesh-devices does not run: more NCCL ranks than the card
        count (one GPU per rank; it does not run fewer), and a negative N."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert run.main(["--demo", "--mesh-devices", "2"]) == 2
        assert "one GPU per rank" in capsys.readouterr().err
        assert run.main(["--demo", "--device", "cpu", "--mesh-devices", "-1"]) == 2

    def test_recorded_stream_input(self, tmp_path):
        frames = run._demo_frames(Params(width=128, height=64, fx=60.0, fy=60.0, cx=64.0,
                                         cy=32.0), n_frames=5)
        d = tmp_path / "stream"
        os.makedirs(d)
        for i, f in enumerate(frames):
            RecordedStream.write_frame(str(d), i, f)
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text("width: 128\nheight: 64\nfx: 60.0\nfy: 60.0\ncx: 64.0\ncy: 32.0\n"
                       "skybox_points_num: 16\ninitial_capacity: 4096\ndensify_budget: 1024\n"
                       "max_iters_per_keyframe: 1\n")
        made = []

        def factory(*a, **k):
            made.append(MappingEngine(*a, **k))
            return made[-1]

        assert run.main(["--input", str(d), "--config", str(cfg), "--device", "cpu",
                         "--quiet"], engine_factory=factory) == 0
        (eng,) = made
        assert eng.kf_count == 1 and eng.gm.skybox_count == 16


class _StubEngine:
    """Minimal engine for run_stream's watchdog semantics."""

    def __init__(self, delay=0.0):
        self.delay, self.initialized, self.last_metrics = delay, False, {}
        self.kf_count, self.timers, self.frames_seen = 0, PhaseTimers(), 0

    def add_frame(self, frame):
        self.frames_seen += 1
        self.initialized = True
        time.sleep(self.delay)
        return False


def _frames(n, gap_after=None, gap_s=0.0):
    for i in range(n):
        if i == gap_after:
            time.sleep(gap_s)
        yield FrameInput(float(i) * 0.1, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                         np.zeros((4, 6, 3), np.uint8), np.array([[0.0, 0.0, 2.0]], np.float32),
                         np.full((1, 3), 0.5, np.float32))


class TestWatchdog:
    """The watchdog fires on source silence (mapping.cpp:224-234), never on
    the engine's own processing time."""

    def test_slow_engine_does_not_trip(self, monkeypatch):
        monkeypatch.setattr(run, "Watchdog", lambda: Watchdog(timeout=0.05))
        eng = _StubEngine(delay=0.12)
        assert run.run_stream(eng, _frames(4), verbose=False)["frames"] == 4

    def test_source_gap_trips(self, monkeypatch):
        monkeypatch.setattr(run, "Watchdog", lambda: Watchdog(timeout=0.05))
        eng = _StubEngine()
        assert run.run_stream(eng, _frames(6, gap_after=3, gap_s=0.3), verbose=False)["frames"] == 3


class TestQuietStream:
    def test_verbose_false_writes_nothing_and_returns_the_stats(self, capsys):
        """A demo stream with `verbose=False` writes nothing to stdout (the
        aligner's kind and the runtime stats are the CLI's to print); the
        stats come back instead."""
        from gaussian_lic_tpu_torch.config import load_params

        cfg = load_params(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0,
                          skybox_points_num=0, initial_capacity=1 << 12, densify_budget=1 << 10,
                          max_train_keyframes=64, max_iters_per_keyframe=1)
        frames = list(run._demo_frames(cfg, 10))
        eng = MappingEngine(cfg, device="cpu")
        capsys.readouterr()
        stats = run.run_stream(eng, frames, use_aligner=True, verbose=False)
        assert capsys.readouterr().out == ""
        t = eng.timers
        assert stats == {"frames": 10, "wall_s": stats["wall_s"], "watchdog": False,
                         "keyframes": 2, "frames_s": 10 / stats["wall_s"],
                         "optimize_s": t.optimize_steps, "adding_s": t.adding,
                         "extending_s": t.extending, "compiles": t.compiles}
        assert eng.kf_count == 2 and t.extending > 0 and t.compiles > 0

    def test_quiet_cli_prints_the_aligner_and_the_stats(self, capsys):
        """`--quiet` drops the line a keyframe; the CLI still prints the
        aligner's kind and the runtime stats `run_stream` returns."""
        assert run.main(["--demo", "--device", "cpu", "--demo-frames", "5", "--max-iters", "1",
                         "--quiet"]) == 0
        text = capsys.readouterr().out
        assert "[stream] aligner: native" in text and "[frame" not in text
        assert "===== runtime stats" in text and "frames processed      : 5" in text
