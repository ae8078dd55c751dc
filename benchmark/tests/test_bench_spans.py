"""The readers of the program's spans and counters (metrics/eval_*.render,
replay_ms.train, optimize_syncs.train; harness/spans.py) on the CPU: finite
on a traced tiny cell, None on an untraced run and on a program without
the trace module."""

from __future__ import annotations

import json
import math
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from conftest import REPO, TINY_RENDER, TINY_TRAIN
from harness import cli, spec

from gaussian_lic_tpu_torch import utils
from gaussian_lic_tpu_torch.utils import trace

READERS = {TINY_RENDER: ("eval_sync_ms.render", "eval_issue_ms.render", "eval_syncs.render"),
           TINY_TRAIN: ("replay_ms.train", "optimize_syncs.train")}


def _traced(root, cell, monkeypatch, capsys):
    """A `--trace 1` run of a tiny cell on the CPU (the traced window ends
    in torch.cuda.synchronize(), which a CPU build cannot make) and its
    result line."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rc = cli.main(["--workload", cell, "--seed", "3000000023", "--seconds", "0.2",
                   "--trace", "1"], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-2][len("info "):]), json.loads(out[-1])


def test_the_render_readers_read_a_traced_tiny_cell(tiny_root, monkeypatch, capsys):
    info, res = _traced(tiny_root, TINY_RENDER, monkeypatch, capsys)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS[TINY_RENDER]) <= set(m)
    assert all(math.isfinite(m[k]) and m[k] > 0 for k in READERS[TINY_RENDER])
    # tiny_render: 3 keyframe views, 5 held-out, one call
    assert m["eval_syncs.render"] == (3 * 1 + 5 * 6 + 2) / 8
    per_view_ms = info["window_s"] * 1e3 / 8
    assert m["eval_sync_ms.render"] + m["eval_issue_ms.render"] <= per_view_ms


def test_the_train_readers_read_a_traced_tiny_cell(tiny_root, monkeypatch, capsys):
    """The CPU runs eager steps: no graph, so no replay to read."""
    _, res = _traced(tiny_root, TINY_TRAIN, monkeypatch, capsys)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["optimize_syncs.train"] == 3
    assert "replay_ms.train" not in m


def test_replay_ms_is_the_replay_time_a_step_replayed():
    """Two calls, each a 4-step and a 1-step graph: their summed replay
    time over the 10 steps."""
    with trace.span("unrecorded"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("optimize"):
                for k in (4, 1):
                    with trace.span("bundle", k):
                        with trace.span("bundle.replay", k):
                            time.sleep(0.001 * k)
    ns = [s.ns for s in trace.record().spans if s.name == "bundle.replay"]
    run = SimpleNamespace(layer={"trace": {}})
    got = spec.reader(REPO, "replay_ms.train").read(run)
    assert len(ns) == 4 and got == sum(ns) * 1e-6 / 10 and got >= 1


@pytest.mark.parametrize("name", [n for names in READERS.values() for n in names])
def test_none_untraced_and_without_the_trace_module(name, monkeypatch):
    reader = spec.reader(REPO, name)
    assert reader.read(SimpleNamespace(layer={"views": 8, "steps": 300})) is None
    # as in a checkout whose program has no trace module
    monkeypatch.setitem(sys.modules, "gaussian_lic_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace")
    assert reader.read(SimpleNamespace(layer={"trace": {}, "views": 8, "steps": 300})) is None
