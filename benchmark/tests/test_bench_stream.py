"""The `stream` kind on the CPU: a tiny stream cell that the test adds (new
files and entries only, as conftest's tiny cells) runs through `cli.main`
on the port's plain versions, is correct, reports `train_it_s`, appends the
same rows in every window call and grows nothing; its traced run reads the
four stream metrics; the two faults of the extend read over a limit, as
controls (control_stream.py) and, the opacity test's, planted in the port.
On the card (`requires_cuda`): the checked cycle replays the graph its
first run captured, and a copy-in left out of the graphs reads not
correct."""

from __future__ import annotations

import json
import math
import os

import pytest
import torch

from conftest import add_tiny_cells
from harness import cli, spec

TINY_STREAM = "tiny.stream"
STREAM_METRICS = ("ingest_ms.stream", "extend_ms.stream", "keyframe_syncs.stream",
                  "idle_pct.stream")


@pytest.fixture
def stream_root(tmp_path):
    """conftest's tiny root plus a `stream` cell on its 128x64 configuration,
    its map in twice the rows: 8 keyframes (more than its 5 steps a
    keyframe), 10 frames (2 keyframe cycles) of 200 points."""
    root = str(tmp_path)
    add_tiny_cells(root)
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "tiny.json")))
    cfg["assumed"]["map_rows"] *= 2
    json.dump(cfg, open(os.path.join(b, "configs", "tiny_stream.json"), "w"))
    mix = json.load(open(os.path.join(b, "traffic", "stream.json")))
    mix.update(keyframes=8, frames=10, points_per_frame=200, max_settle_calls=3, trace_calls=1)
    json.dump(mix, open(os.path.join(b, "traffic", "tiny_stream.json"), "w"))
    sp = json.load(open(os.path.join(root, "BENCHMARK.json")))
    sp["workloads"].append(dict(name=TINY_STREAM, config="tiny_stream", traffic="tiny_stream",
                                chips=1, why="tests"))
    sp["configs"].append(dict(name="tiny_stream", source="tests",
                              file="benchmark/configs/tiny_stream.json", reduced=[], why="tests"))
    for m in sp["end_to_end"] + sp["per_layer"]:
        if "fastlivo.stream" in m.get("workloads", ()):
            m["workloads"].append(TINY_STREAM)
    json.dump(sp, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def _run(root, capsys, trace=0, seconds=0.2, seed=3000000037, device="cpu"):
    """One run of the tiny cell through `cli.main`; `device` None takes the card."""
    rc = cli.main(["--workload", TINY_STREAM, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], root=root, device=device)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-2][len("info "):]), json.loads(out[-1])


def test_the_cell_is_named_in_the_benchmark():
    from conftest import REPO

    sp = spec.spec(REPO)
    assert spec.cell(sp, "fastlivo.stream")["traffic"] == "stream"
    assert spec.cell(sp, "fastlivo.stream")["config"] == "fastlivo_stream"
    assert spec.problems(sp, REPO) == []
    assert [m["name"] for m in spec.per_layer(sp, "fastlivo.stream")] == list(STREAM_METRICS)
    assert {m["name"] for m in spec.end_to_end(sp, "fastlivo.stream")} == {"train_it_s",
                                                                         "setup_s"}


def test_the_stream_configuration_is_the_shipped_rig_with_room_for_a_call():
    """The stream's configuration runs fastlivo.yaml's parameters as the
    fastlivo configuration does, its map fastlivo's live Gaussians; its rows
    hold every point of a call's frames past them, so no extend grows it."""
    from conftest import REPO

    sp = spec.spec(REPO)
    cfg = spec.config(REPO, "fastlivo_stream")
    ship = spec.config(REPO, "fastlivo")
    mix = spec.traffic(REPO, spec.cell(sp, "fastlivo.stream")["traffic"])
    entry = next(c for c in sp["configs"] if c["name"] == "fastlivo_stream")
    assert cfg["params"] == ship["params"] and cfg["params_source"] == ship["source"]
    assert cfg["source"] == entry["source"] != ship["source"] and entry["reduced"] == []
    a = cfg["assumed"]
    assert a["map_live"] == ship["assumed"]["map_live"]
    assert a["map_rows"] - a["map_live"] >= mix["frames"] * mix["points_per_frame"]
    assert mix["points_per_frame"] == a["lidar_points_per_s"] // a["lidar_hz"]


def test_a_stream_cell_runs_correct_and_grows_nothing(stream_root, capsys):
    """The set-up's first call feeds the cycles one by one, its second and
    the window's feed them whole: all append the same rows."""
    info, res = _run(stream_root, capsys)
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == {"train_it_s", "setup_s"}
    assert res["metrics"]["train_it_s"]["value"] > 0
    assert res["failed"] == 0 and res["attempted"] == info["window_calls"] * 2 * 5
    assert info["settle_calls"] == 2 and info["window_appended"] == [sum(
        info["appended_per_keyframe"])]
    assert info["window_captures"] == 0 and info["window_growths"] == 0
    assert len(info["appended_per_keyframe"]) == 2 and min(info["appended_per_keyframe"]) > 0
    assert info["kf_buffer_rows"] >= 8 + 2 and info["map_rows"] == 8192
    for v in res["compared"].values():
        assert 0 <= v["value"] <= v["limit"]


def test_the_stream_readers_read_a_traced_tiny_cell(stream_root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    info, res = _run(stream_root, capsys, trace=1)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # the program's spans and counter; the CPU traces no device time to idle
    assert set(m) & set(STREAM_METRICS) == set(STREAM_METRICS[:3]), m
    assert all(math.isfinite(m[k]) and m[k] > 0 for k in STREAM_METRICS[:3])
    assert m["ingest_ms.stream"] * 10 + m["extend_ms.stream"] * 2 <= info["window_s"] * 1e3
    # a keyframe: its camera's 4 uploads and its image's at ingest, the
    # extend's count fetched twice and its 4 uploads, optimize()'s draw
    # upload and 2 fetches
    assert m["keyframe_syncs.stream"] == 14


@pytest.mark.parametrize("what", ["dedup_farthest", "no_alpha_test"])
def test_each_fault_of_the_extend_reads_over_a_limit(stream_root, what):
    import control_stream

    lim = spec.traffic(stream_root, "tiny_stream")["limits"]
    g = control_stream.readings(stream_root, TINY_STREAM, 2147483659, "cpu", what)
    assert any(g[k] > lim[k] for k in g), g


def test_the_opacity_test_left_out_of_the_port(stream_root, capsys, monkeypatch):
    """The extend's render made fully transparent: every pixel passes the
    alpha < 0.99 test, as without it."""
    from gaussian_lic_tpu_torch.engine import trainer

    real = trainer.render_map

    def clear(gm, cam, **kw):
        out = real(gm, cam, **kw)
        return out._replace(final_T=torch.ones_like(out.final_T)) if kw.get("no_color") else out

    monkeypatch.setattr(trainer, "render_map", clear)
    _, res = _run(stream_root, capsys)
    assert res["correct"] is False
    assert res["compared"]["added_gap"]["value"] > res["compared"]["added_gap"]["limit"]


@pytest.mark.requires_cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="the train bundles' CUDA graphs and their copy-in run only on the card")
def test_on_the_card_the_check_reads_the_graphs_copy_in(stream_root, capsys, monkeypatch):
    """The checked cycle's second run replays the 1-step graph its first
    captured: sound, it is correct; with the copy-in after the extend left
    out of `BundleGraphs.run` (the capture's own copy-back kept), the graph
    trains the restored map without the appended rows and reads not
    correct."""
    from gaussian_lic_tpu_torch.engine import trainer

    info, res = _run(stream_root, capsys, device=None)
    assert res["correct"] is True, res["compared"]
    assert info["checked_recaptures"] == 0 and info["window_captures"] == 0

    real = trainer.BundleGraphs._store

    def stale(self, gm, opt_state):
        if torch.cuda.is_current_stream_capturing():
            real(self, gm, opt_state)

    monkeypatch.setattr(trainer.BundleGraphs, "_store", stale)
    info, res = _run(stream_root, capsys, device=None)
    assert info["checked_recaptures"] == 0
    assert res["correct"] is False
    assert res["compared"]["added_gap"]["value"] > res["compared"]["added_gap"]["limit"]
