"""The harness on the CPU: its parts are found by name, its names keep to the
contract's characters, nothing it runs loads JAX or the JAX package, the
stage bounds agree with counts by hand, the inputs follow the seed, and a
cell that the test adds runs end to end on the port's plain versions."""

from __future__ import annotations

import ast
import glob
import json
import os

import pytest
import torch

from conftest import BENCH, REPO, TINY_RENDER, TINY_TRAIN
from harness import bounds, cli, spec, state


def _run(root, cell, capsys, trace=0, seed=3000000019):
    rc = cli.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                   "--trace", str(trace)], root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_every_part_is_found_by_name():
    sp = spec.spec(REPO)
    assert spec.problems(sp, REPO) == []
    for w in sp["workloads"]:
        kind = spec.kind(REPO, spec.traffic(REPO, w["traffic"])["kind"])
        for fn in ("setup", "window", "release", "check", "inputs", "reference", "gaps"):
            assert callable(getattr(kind, fn)), (w["name"], fn)
        assert spec.per_layer(sp, w["name"]), w["name"]
        assert {"setup_s"} < {m["name"] for m in spec.end_to_end(sp, w["name"])}
    for m in sp["per_layer"]:
        assert spec.reader(REPO, m["name"]).read(type("R", (), {"layer": {}})()) is None


def test_names_and_units_keep_to_the_allowed_characters():
    sp = spec.spec(REPO)
    assert spec.problems(sp) == []
    bad = json.loads(json.dumps(sp))
    bad["per_layer"][0]["unit"] = "tokens per second"
    bad["workloads"][0]["name"] = "a b"
    bad["end_to_end"][0]["unit"] = "x" * 17
    assert len(spec.problems(bad)) == 3
    for m in sp["end_to_end"] + sp["per_layer"]:
        assert spec.UNIT.match(m["unit"]) and len(m["unit"]) <= 16


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                                                  recursive=True)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(cli.FORBIDDEN), path
    if os.sep + "reference" + os.sep in path:
        assert "gaussian_lic_tpu_torch" not in tops, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gaussian_lic_tpu_torch_fake", object())
    assert "gaussian_lic_tpu" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in cli.forbidden_modules()


def _counts(**kw):
    c = dict(applied=100, stopped=10, entries=50, tiles=2, pixels=64, visible=5, live=8)
    c.update(kw)
    return c


def test_stage_bounds_agree_with_hand_counts():
    c = _counts()
    fwd_bytes = 50 * 36 + 8 * 2 + 20 * 64
    fwd = max((19 * 110 + 7 * 100) / bounds.FP32_INSTR_PER_S, 110 / bounds.MUFU_PER_S,
              fwd_bytes / bounds.HBM_BYTES_PER_S)
    bwd_bytes = 50 * 40 + 8 * 2 + 20 * 64 + 5 * 36
    bwd = max(45 * 100 / bounds.FP32_INSTR_PER_S, 2 * 100 / bounds.MUFU_PER_S,
              bwd_bytes / bounds.HBM_BYTES_PER_S)
    assert bounds.blend(c) == pytest.approx(fwd + bwd, rel=1e-12)
    pre = (8 * 236 + 5 * 36 + 8 * 8) + (5 * (36 + 236) + 5 * 236) + 5 * 236 * 7
    assert bounds.preprocess_adam(c) == pytest.approx(pre / bounds.HBM_BYTES_PER_S, rel=1e-12)
    assert bounds.binning(c) == pytest.approx((8 * 33 + 50 * 40 + 16) / bounds.HBM_BYTES_PER_S)
    s = bounds.step(c)
    assert s["step"] == pytest.approx(s["blend"] + s["preprocess_adam"] + s["binning"] + s["loss"])


def test_adam_bound_scales_with_visible_rows_not_all_rows():
    base = bounds.preprocess_adam(_counts(visible=1000, live=4000))
    more_rows = bounds.preprocess_adam(_counts(visible=1000, live=4000, rows=1 << 20))
    assert more_rows == base
    adam = lambda v: bounds.seconds(nbytes=v * 236 * 7)  # noqa: E731
    assert (bounds.preprocess_adam(_counts(visible=2000, live=4000))
            - bounds.preprocess_adam(_counts(visible=1000, live=4000))) == pytest.approx(
        adam(2000) - adam(1000) + bounds.seconds(nbytes=1000 * (36 + 272 + 236)), rel=1e-9)


def test_inputs_follow_the_seed():
    p = json.load(open(os.path.join(BENCH, "configs", "fastlivo.json")))["params"]
    p = dict(p, width=32, height=16, skybox_points_num=10)

    def draw(seed):
        g = state.generator(seed, "cpu")
        return state.map_params(g, p, 64, 50, "cpu"), state.images(g, 2, p, "cpu")

    (a, ia), (b, ib), (c, ic) = draw(2 ** 31 + 5), draw(2 ** 31 + 5), draw(2 ** 31 + 6)
    assert all(torch.equal(a[k], b[k]) for k in a) and torch.equal(ia, ib)
    assert not torch.equal(a["xyz"], c["xyz"]) and not torch.equal(ia, ic)
    assert torch.equal(a["xyz"][50:], torch.zeros(14, 3))


@pytest.mark.parametrize("cell", [TINY_TRAIN, TINY_RENDER])
def test_a_cell_the_test_adds_runs_and_is_correct(tiny_root, cell, capsys):
    rc, res = _run(tiny_root, cell, capsys)
    assert rc == 0 and res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] > 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    assert list(res)[-1] == "compared"
    for v in res["compared"].values():
        assert 0 <= v["value"] <= v["limit"]


def test_without_a_card_the_run_fails_and_prints_no_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = cli.main(["--workload", TINY_TRAIN, "--seed", "1", "--seconds", "1"], root=tiny_root)
    assert rc != 0 and capsys.readouterr().out == ""
