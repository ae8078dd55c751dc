"""The port's production-scale tools against the JAX repo's: tools/soak_torch.py
(tools/soak.py), tools/validate_scale_torch.py (tools/validate_scale.py) and
tools/bag_to_stream_torch.py (tools/bag_to_stream.py).

The soak and the validation run through their own `main(argv)` with `--tiny
--device cpu` at a few frames (the plain PyTorch versions of the kernels).
Their summary and record keys are read from the JAX tools' source (running
the JAX engine here takes minutes of interpret-mode Pallas); their PASS rules
are exercised both ways, the FAIL side by an engine whose steps report a
binning overflow. The converter's npz directory must equal the JAX tool's on
the same bag, file by file and array by array (exactly).
"""

import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from ros_wire import mk_frames
from test_rosbag import _write_bag

from torch_port_helpers import ROOT

from gaussian_lic_tpu_torch.engine import trainer

TINY = ["--tiny", "--device", "cpu", "--points", "400"]


def tool(name):
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dict_keys(name: str, var: str) -> set:
    """Keys of the dict literal assigned to `var` in tools/<name>.py."""
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == var for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict literal {var} in tools/{name}.py")


def last_json(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


@pytest.fixture
def overflowing(monkeypatch):
    """Every optimize() reports one slot lost to the splat budget."""
    real = trainer.MappingEngine.optimize

    def optimize(self, *a, **k):
        out = real(self, *a, **k)
        self.last_metrics.update(budget_lost=1.0, overflow=1.0)
        return out

    monkeypatch.setattr(trainer.MappingEngine, "optimize", optimize)


class TestSoak:
    def test_tiny_run_passes(self, tmp_path, capsys):
        out = tmp_path / "soak.json"
        rc = tool("soak_torch").main(TINY + ["--frames", "10", "--skybox", "0", "--iters", "5",
                                             "--psnr-every", "1", "--out", str(out)])
        text = capsys.readouterr().out
        assert rc == 0 and "SOAK PASS" in text
        summary = last_json(text)
        assert set(summary) == dict_keys("soak", "summary")
        saved = json.loads(out.read_text())
        assert saved["summary"] == json.loads(json.dumps(summary))
        recs = saved["keyframes"]
        assert [r["kf"] for r in recs] == [1, 2] and [r["frame"] for r in recs] == [4, 9]
        for r in recs:
            assert set(r) == dict_keys("soak", "rec") | {"psnr_kf"}
        assert summary["keyframes"] == 2 and summary["iters_total"] == 3
        assert summary["train_psnr"] > 17.0 and summary["overflow_second_half"] == 0
        assert summary["psnr_trajectory"] == [[1, recs[0]["psnr_kf"]], [2, recs[1]["psnr_kf"]]]
        # no keyframe is past max_iters // 2 = 2 yet: no steady state
        assert summary["steady_kf_wall_s"] is None and summary["realtime_x"] is None

    def test_overflow_in_second_half_fails(self, tmp_path, capsys, overflowing):
        rc = tool("soak_torch").main(TINY + ["--frames", "5", "--skybox", "0", "--iters", "1",
                                             "--psnr-every", "0", "--out",
                                             str(tmp_path / "s.json")])
        text = capsys.readouterr().out
        assert rc == 1 and "SOAK FAIL" in text
        assert last_json(text)["overflow_second_half"] == 1

    @pytest.mark.parametrize("case,ok", [
        (dict(), True),
        (dict(train_psnr=17.0), False),
        (dict(train_psnr=float("nan")), False),
        (dict(overflow_second_half=1), False),
        (dict(compiles=8 + 16 + 1), False),
        (dict(compiles=8 + 16), True),
    ])
    def test_pass_rule(self, case, ok):
        """tools/soak.py's rule: PSNR > 17, no late overflow, compiles <=
        8 + log2(gaussians) (here 2^16 Gaussians)."""
        case = dict(case)
        compiles = case.pop("compiles", 3)
        summary = dict(dict(train_psnr=20.0, overflow_second_half=0), **case)
        assert tool("soak_torch").soak_passes(summary, compiles, 1 << 16) is ok


class TestValidateScale:
    def test_tiny_run_passes(self, capsys):
        rc = tool("validate_scale_torch").main(TINY + ["--frames", "15", "--iters", "10"])
        text = capsys.readouterr().out
        assert rc == 0 and "VALIDATION PASS" in text
        summary = last_json(text)
        assert set(summary) == dict_keys("validate_scale", "summary")
        assert summary["keyframes"] == 3 and summary["max_overflow"] == 0
        assert summary["train_psnr"] > 17.0

    def test_overflow_fails(self, capsys, overflowing):
        rc = tool("validate_scale_torch").main(TINY + ["--frames", "5", "--iters", "1"])
        text = capsys.readouterr().out
        assert rc == 1 and "VALIDATION FAIL" in text and last_json(text)["max_overflow"] == 1

    def test_psnr_bar(self):
        bar = tool("validate_scale_torch").psnr_bar
        assert (bar(999), bar(1000)) == (17.0, 20.0)


@pytest.mark.parametrize("name", ["soak_torch", "validate_scale_torch"])
def test_no_cuda_exits_nonzero(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool(name).main([]) == 2
    assert "--device cpu" in capsys.readouterr().err


def npz_dir(path) -> dict:
    out = {}
    for f in sorted(os.listdir(path)):
        with np.load(os.path.join(path, f)) as z:
            out[f] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("chunked,comp", [(False, "none"), (True, "bz2")])
def test_bag_to_stream_matches_jax(tmp_path, rng, monkeypatch, capsys, chunked, comp):
    bag = str(tmp_path / "t.bag")
    _write_bag(bag, mk_frames(rng, n=4), chunked=chunked, compression=comp)
    got, want = tmp_path / "torch", tmp_path / "jax"
    assert tool("bag_to_stream_torch").main([bag, str(got)]) == 0
    monkeypatch.setattr(sys, "argv", ["bag_to_stream.py", bag, str(want)])
    assert tool("bag_to_stream").main() == 0
    assert capsys.readouterr().out.count("wrote 4 aligned frames") == 2
    a, b = npz_dir(got), npz_dir(want)
    assert list(a) == list(b) and len(a) == 4
    for f in a:
        assert list(a[f]) == list(b[f]), f
        for k in a[f]:
            assert a[f][k].dtype == b[f][k].dtype, (f, k)
            np.testing.assert_array_equal(a[f][k], b[f][k], err_msg=f"{f} {k}")


@pytest.mark.parametrize("path", ["tools/soak_torch.py", "tools/validate_scale_torch.py",
                                  "tools/bag_to_stream_torch.py", "chip_smoke.py",
                                  "gaussian_lic_tpu_torch/ops/rasterize_ref.py"])
def test_imports_no_jax(path):
    """The card's machine has no JAX: these import neither it nor the JAX package."""
    import re

    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|gaussian_lic_tpu)\b(?!_torch)", src, re.M)
    assert "gaussian_lic_tpu." not in src.replace("gaussian_lic_tpu_torch", "")


# phase 4's lines as chip_smoke.bundle_turns prints them: the capturing pass
# first, then the turns eager, bundle, bundle, eager
PHASE_4_LINES = """\
[4] bundles 64+16+16+4 of 100 steps: first pass (captures included) 103.519 ms/step; captures []
[4] 1048576 Gaussians 640x512 (H100, 700.00 W), eager: 37.421 ms/step, 26.723 it/s, loss 0.25
[4] 1048576 Gaussians 640x512 (H100, 700.00 W), bundle: 23.357 ms/step, 42.814 it/s, loss 0.25
[4] 1048576 Gaussians 640x512 (H100, 700.00 W), bundle: 23.350 ms/step, 42.826 it/s, loss 0.25
[4] 1048576 Gaussians 640x512 (H100, 700.00 W), eager: 37.573 ms/step, 26.615 it/s, loss 0.25
[4] phase seconds 22.92
"""


def test_ab_train_step_reads_the_turns_not_the_capturing_pass():
    """tools/ab_train_step.py takes a run's bundle and eager ms/step as the
    means of its turns, not the first [4] line (the pass that captures the
    graphs), and K1's and K2's ms from a --kernels run."""
    ab = tool("ab_train_step")
    bundle, eager = ab._readings(PHASE_4_LINES, kernels=False)
    assert bundle == pytest.approx((23.357 + 23.350) / 2)
    assert eager == pytest.approx((37.421 + 37.573) / 2)
    assert ab._readings(PHASE_4_LINES.splitlines()[0], kernels=False) is None
    assert ab._readings("[ab] H100, 700.00 W: K1 0.6921 ms  K2 1.1694 ms\n",
                        kernels=True) == (0.6921, 1.1694)
    assert ab._readings(PHASE_4_LINES, kernels=True) is None


def test_k6_occupancy_needs_the_card_and_finds_its_bounds(monkeypatch, capsys):
    """tools/k6_occupancy.py exits 2 without CUDA, and the launch bounds it
    rewrites in its copies of csrc/ are K6's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    occ = tool("k6_occupancy")
    assert occ.main([]) == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc",
                           "preprocess_backward.cuh")) as f:
        assert f.read().count(occ.BOUNDS) == 1


def test_ab_train_step_reads_every_kernel_of_the_step():
    """A --kernels run prints K1, K2, K5, K6, K7, K8, K13, K9, K10, K11 and
    K12, and K5f and K6f (K5 and K6 with the activations); the tool reads
    them in the order printed and pairs each with its name (a checkout
    before K8-K12 prints the first five), its child times each of them, and
    K8-K13 in a CUDA graph of 20 calls (chip_smoke.graph_ms), not eagerly."""
    ab = tool("ab_train_step")
    line = ("[ab] NVIDIA H100 80GB HBM3, 700.00 W: K1 0.6921 ms  K2 1.1694 ms  K5 0.1571 ms  "
            "K6 0.2006 ms  K7 0.5943 ms")
    assert ab._readings("other\n" + line + "\n", kernels=True) == (0.6921, 1.1694, 0.1571,
                                                                   0.2006, 0.5943)
    assert ab._readings(line + "  K8 0.0440 ms  K9 0.0223 ms  K10 0.0768 ms  K11 0.0400 ms  "
                        "K12 0.0300 ms\n", kernels=True) == (
        0.6921, 1.1694, 0.1571, 0.2006, 0.5943, 0.044, 0.0223, 0.0768, 0.04, 0.03)
    assert ab.KERNELS == ("K1", "K2", "K5", "K6", "K7", "K8", "K13", "K9", "K10", "K11",
                          "K12", "K5f", "K6f")
    # K5 and K6 with the activations (the parent's ops around them, or the fold)
    assert ab._readings(line + "  K5f 0.1500 ms  K6f 0.1950 ms\n", kernels=True)[-2:] == (
        0.15, 0.195)
    for k in ab.KERNELS:
        assert f'ms["{k}"]' in ab._KERNELS or f'"{k}":' in ab._KERNELS
    for k in ("K8", "K13", "K9", "K10", "K11", "K12"):
        assert f'ms["{k}"] = cs.graph_ms(' in ab._KERNELS


@pytest.mark.parametrize("kernel,owner", [
    ("void glic_ssim::ssim_forward_kernel<true>(float const*, long long, long long, float "
     "const*, long long, long long, int, int, int, int, int, glic_ssim::Konst, float*, float*)",
     "K11 ssim forward"),
    ("glic_ssim::ssim_forward_kernel<false>(float const*, long long)", "K11 ssim forward"),
    ("glic_ssim::ssim_backward_kernel(float const*, long long, long long, float const*, long "
     "long, long long, int, int, int, int, int, glic_ssim::Konst, float const*, float const*, "
     "float*)", "K12 ssim backward"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
])
def test_profile_owners_of_the_loss_kernels(kernel, owner):
    """tools/profile_torch_step.py gives K11's and K12's kernels (both
    instantiations of K11) their owners, and PyTorch's elementwise kernels
    stay elementwise."""
    assert tool("profile_torch_step").owner(kernel) == owner


@pytest.mark.parametrize("kernel", [
    "glic_k13::radix_compact_live_kernel(int const*, long long, int*, int*, int*, unsigned "
    "long long*)",
    "glic_k13::radix_histogram_kernel(int const*, int*)",
    "glic_k13::radix_onesweep_kernel(int const*, int const*, int*, int*, int*, unsigned long "
    "long*, int)",
])
def test_owners_of_the_live_sort_kernels(kernel):
    """K13's three kernels are the binning's sort in tools/profile_torch_step.py's
    owner table and in the benchmark's frozen copy of it (their names hold
    `radix`, as torch.sort's kernels did), never "other"."""
    path = os.path.join(ROOT, "benchmark", "harness", "owners.py")
    spec = importlib.util.spec_from_file_location("bench_owners", path)
    owners = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(owners)
    assert owners.owner(kernel) == "sort" and "sort" in owners.STAGES["binning"]
    assert tool("profile_torch_step").owner(kernel) == "sort"
