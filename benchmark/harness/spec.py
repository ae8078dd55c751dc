"""Finding a cell's parts by name: `BENCHMARK.json` at the root of the
checkout, a configuration in `benchmark/configs/<config>.json`, a traffic
mix in `benchmark/traffic/<traffic>.json` (data: its `kind` names the
module `benchmark/kinds/<kind>.py` that plays it), and a per-layer metric's
reader in `benchmark/metrics/<metric>.py`. Adding a cell, a configuration,
a traffic mix of a known kind or a metric adds files and entries and edits
none."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH_DIR = "benchmark"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: str, name: str) -> dict:
    return load_json(os.path.join(root, BENCH_DIR, "configs", f"{name}.json"))


def traffic(root: str, name: str) -> dict:
    return load_json(os.path.join(root, BENCH_DIR, "traffic", f"{name}.json"))


def _module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    s = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def kind(root: str, name: str):
    return _module(os.path.join(root, BENCH_DIR, "kinds", f"{name}.py"), f"bench_kind_{name}")


def reader(root: str, metric: str):
    return _module(os.path.join(root, BENCH_DIR, "metrics", f"{metric}.py"),
                   "bench_metric_" + metric.replace(".", "_").replace("-", "_"))


def end_to_end(sp: dict, cell_name: str) -> list:
    return [m for m in sp["end_to_end"] if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(sp: dict, cell_name: str) -> list:
    """The per-layer metrics whose `workloads` list the cell (every one has
    the list: problems() says so)."""
    return [m for m in sp["per_layer"] if cell_name in m.get("workloads", ())]


def problems(sp: dict, root: Optional[str] = None) -> list:
    """What in `sp` breaks the naming rules, or names a file that is not
    there (with `root`)."""
    out = []
    named = ([("config", c["name"]) for c in sp["configs"]]
             + [("workload", w["name"]) for w in sp["workloads"]]
             + [("metric", m["name"]) for m in sp["end_to_end"] + sp["per_layer"]])
    for what, n in named:
        if not NAME.match(n):
            out.append(f"{what} name {n!r}")
    for w in sp["workloads"]:
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"{w['name']}: {k} {w[k]!r}")
    for c in sp["configs"]:
        out += [f"{c['name']}: reduced key {k!r}" for k in c["reduced"] if not NAME.match(k)]
    out += [f"{m['name']}: no workloads" for m in sp["per_layer"] if "workloads" not in m]
    for m in sp["end_to_end"] + sp["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: unit {m['unit']!r}")
    for kind_, items in (("configs", sp["configs"]), ("workloads", sp["workloads"]),
                         ("metrics", sp["end_to_end"] + sp["per_layer"])):
        names = [i["name"] for i in items]
        if len(names) != len(set(names)):
            out.append(f"duplicate names among {kind_}")
    if root is not None:
        for w in sp["workloads"]:
            cfg = os.path.join(root, BENCH_DIR, "configs", f"{w['config']}.json")
            mix = os.path.join(root, BENCH_DIR, "traffic", f"{w['traffic']}.json")
            out += [f"{w['name']}: missing {p}" for p in (cfg, mix) if not os.path.exists(p)]
            if os.path.exists(mix):
                k = traffic(root, w["traffic"])["kind"]
                if not os.path.exists(os.path.join(root, BENCH_DIR, "kinds", f"{k}.py")):
                    out.append(f"{w['name']}: missing kind {k}")
        for m in sp["per_layer"]:
            if not os.path.exists(os.path.join(root, BENCH_DIR, "metrics", f"{m['name']}.py")):
                out.append(f"{m['name']}: missing reader")
    return out
