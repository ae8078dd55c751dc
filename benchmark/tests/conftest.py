"""Fixtures of the benchmark's own tests: a checkout root that holds the
repository's BENCHMARK.json and benchmark files plus tiny cells that the
tests add themselves, the way a later change adds a cell (new files and
entries only)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for p in (BENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TRAIN = "tiny.train"
TINY_RENDER = "tiny.render"


def add_tiny_cells(root: str) -> None:
    """Copies the benchmark to `root` and adds a 128x64, 4,096-row
    configuration with two cells, one of each traffic kind."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "fastlivo.json")))
    cfg["params"].update(width=128, height=64, fx=60.0, fy=60.0, cx=64.0, cy=32.0,
                         skybox_points_num=200, max_iters_per_keyframe=5,
                         opt_bundle_sizes=[4, 1])
    cfg["assumed"].update(map_rows=4096, map_live=3000)
    json.dump(cfg, open(os.path.join(b, "configs", "tiny.json"), "w"))
    train = json.load(open(os.path.join(b, "traffic", "train.json")))
    train.update(keyframes=4, max_settle_calls=3, trace_reps=1)
    json.dump(train, open(os.path.join(b, "traffic", "tiny_train.json"), "w"))
    render = json.load(open(os.path.join(b, "traffic", "render.json")))
    render.update(keyframe_views=3, held_out_views=5, check_views=3, trace_calls=1)
    json.dump(render, open(os.path.join(b, "traffic", "tiny_render.json"), "w"))
    sp = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    sp["workloads"] += [
        dict(name=TINY_TRAIN, config="tiny", traffic="tiny_train", chips=1, why="tests"),
        dict(name=TINY_RENDER, config="tiny", traffic="tiny_render", chips=1, why="tests")]
    sp["configs"].append(dict(name="tiny", source="tests", file="benchmark/configs/tiny.json",
                              reduced=[], why="tests"))
    for m in sp["end_to_end"] + sp["per_layer"]:
        if "workloads" in m:
            kinds = {json.load(open(os.path.join(b, "traffic", f"{w['traffic']}.json")))["kind"]
                     for w in sp["workloads"] if w["name"] in m["workloads"]}
            m["workloads"].append(TINY_TRAIN if "train" in kinds else TINY_RENDER)
    json.dump(sp, open(os.path.join(root, "BENCHMARK.json"), "w"))


@pytest.fixture
def tiny_root(tmp_path):
    add_tiny_cells(str(tmp_path))
    return str(tmp_path)
