"""A run whose timed path is broken underneath comes out not correct: each
fault that a cell can have, planted in the port on the CPU, in a tiny cell
that the test adds (the harness's look for a card skipped); and the control,
the reference with its contractions in TF32 in the program's place, reads
over a limit in those cells."""

from __future__ import annotations

import json

import pytest

from conftest import TINY_RENDER, TINY_TRAIN
from harness import cli


def _run(root, cell, capsys):
    rc = cli.main(["--workload", cell, "--seed", "2147483659", "--seconds", "0.2",
                   "--trace", "0"], root=root, device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_step_that_returns_its_state_unchanged(tiny_root, capsys, monkeypatch):
    from gaussian_lic_tpu_torch.engine import trainer

    real = trainer.train_step

    def unchanged(gm, opt_state, *a, **kw):
        _, _, metrics = real(gm, opt_state, *a, **kw)
        return gm, opt_state, metrics

    monkeypatch.setattr(trainer, "train_step", unchanged)
    res = _run(tiny_root, TINY_TRAIN, capsys)
    assert res["correct"] is False
    assert res["compared"]["change_gap"]["value"] > res["compared"]["change_gap"]["limit"]


def test_half_the_batch_left_out(tiny_root, capsys, monkeypatch):
    from gaussian_lic_tpu_torch.ops import losses

    real = losses.training_loss

    def half(rendered, gt, lambda_dssim=0.2):
        w = rendered.shape[-1] // 2
        return real(rendered[..., :w].contiguous(), gt[..., :w].contiguous(), lambda_dssim)

    monkeypatch.setattr(losses, "training_loss", half)
    res = _run(tiny_root, TINY_TRAIN, capsys)
    assert res["correct"] is False


@pytest.mark.parametrize("fault", ["state_not_carried", "first_keyframe_for_every_step"])
def test_a_fault_inside_a_multi_step_bundle(tiny_root, capsys, monkeypatch, fault):
    """Faults that only a bundle of several steps can have (on the card, a
    CUDA graph of k steps): each step starting from the bundle's first
    state, or every step reading the first keyframe id."""
    from gaussian_lic_tpu_torch.engine import trainer

    def broken(step, gm, opt_state, kf, idxs, es0):
        metrics = []
        out = gm, opt_state
        for i in range(len(idxs)):
            src = (gm, opt_state) if fault == "state_not_carried" else out
            out = step(*src, kf, idxs[0 if fault != "state_not_carried" else i], es0 + i)
            metrics.append(out[2])
            out = out[:2]
        return out[0], out[1], trainer._bundle_metrics(metrics)

    monkeypatch.setattr(trainer, "_run_steps", broken)
    res = _run(tiny_root, TINY_TRAIN, capsys)
    assert res["correct"] is False, res["compared"]


@pytest.mark.parametrize("where", ["psnr", "ssim"])
def test_an_answer_altered_where_it_is_produced(tiny_root, capsys, monkeypatch, where):
    from gaussian_lic_tpu_torch.ops import losses

    real = getattr(losses, where)
    monkeypatch.setattr(losses, where, lambda a, b: real(a, b) + 0.01)
    res = _run(tiny_root, TINY_RENDER, capsys)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", [TINY_TRAIN, TINY_RENDER])
def test_the_control_fails_in_a_cell_the_test_adds(tiny_root, cell):
    """The TF32 control on the CPU (its operands rounded to TF32) at the
    tiny cell: at least one number reads over its limit."""
    import control
    from harness import spec

    sp = spec.spec(tiny_root)
    lim = spec.traffic(tiny_root, spec.cell(sp, cell)["traffic"])["limits"]
    g = control.readings(tiny_root, cell, 2147483659, "cpu")
    assert any(g[k] > lim[k] for k in g), g
