"""Evaluation at the end of a run (reference C19: evaluateVisualQuality,
gaussian.cpp:721-831).

The counterpart of the JAX package's `engine/evaluate.py`: renders every
train keyframe and every held-out in-sequence test view, one view at a time,
computes PSNR / SSIM / LPIPS per split, and dumps render/ and gt/ PNG pairs.
The per-view metrics stay on the device and come to the host once per split.
Each view is the span `eval.view` (utils/trace.py) with its name as the id:
`eval.inputs`, `eval.render`, `sync.overflow`, `eval.score` inside it.
LPIPS uses the artifact at `lpips_path` (ops.lpips); without one the metric
is reported as None. The PNGs are written by a small zlib encoder, so the
dumps need no imaging library.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gaussian_lic_tpu_torch.camera import Camera, make_camera
from gaussian_lic_tpu_torch.ops import losses
from gaussian_lic_tpu_torch.ops.lpips import LPIPS, load_lpips_params
from gaussian_lic_tpu_torch.ops.rasterize import CHUNK, _splat_budget_for, render_map
from gaussian_lic_tpu_torch.utils import trace


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array: one IDAT chunk, every
    row with filter 0."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb, np.uint8).reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def _to_u8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) in [0, 1] -> (H, W, 3) uint8 on the host."""
    u8 = (img.permute(1, 2, 0) * 255.0).clamp(0, 255).to(torch.uint8)
    return trace.sync("save", u8.cpu).numpy()


def _save_image_pair(result_path: str, name: str, render: torch.Tensor, gt: torch.Tensor):
    for sub, img in (("render", render), ("gt", gt)):
        os.makedirs(os.path.join(result_path, sub), exist_ok=True)
        with open(os.path.join(result_path, sub, name), "wb") as f:
            f.write(png_bytes(_to_u8(img)))


def _lpips_or_none(lpips_path: Optional[str], device) -> Optional[LPIPS]:
    if not lpips_path:
        print("[eval] LPIPS skipped: no lpips_path configured; reporting "
              "lpips=None (see README, 'LPIPS weights')")
        return None
    try:
        return LPIPS(load_lpips_params(lpips_path), device=device)
    except Exception as e:  # missing or unreadable artifact: skip the metric, keep evaluating
        print(f"[eval] LPIPS unavailable ({e}); reporting lpips=None — "
              "export a weights artifact with tools/export_lpips.py "
              "(see README, 'LPIPS weights')")
        return None


@torch.no_grad()
def evaluate_visual_quality(
    engine,
    result_path: Optional[str] = None,
    lpips_path: Optional[str] = None,
    save_images: bool = True,
) -> Dict[str, Optional[float]]:
    """{train,test}_{psnr,ssim,lpips} means (gaussian.cpp:784-789, 824-829).
    lpips is None when no weights artifact is available: the metric is
    reported as skipped, never dropped."""
    cfg, intr, gm, dev = engine.cfg, engine.intr, engine.gm, engine.device
    lpips = _lpips_or_none(lpips_path, dev)

    # Eval renders use the training splat budget, including any growth the
    # trainer made (the reference evals with its training rasterizer
    # settings, gaussian.cpp:753). A view that loses entries past the budget
    # would be cut short, so the budget grows x1.5 and the view is rendered
    # again until nothing is lost.
    budget = [_splat_budget_for(gm.capacity, cfg)]

    def render_clean(cam: Camera) -> torch.Tensor:
        while True:
            with trace.span("eval.render"):
                out = render_map(gm, cam, apply_exposure=cfg.apply_exposure, tile_h=cfg.tile_h,
                                 tile_w=cfg.tile_w,
                                 max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                                 max_total_splats=budget[0])
            lost, truncated = trace.sync("overflow", torch.Tensor.tolist,
                                         torch.stack([out.budget_lost, out.truncated]))
            if lost == 0:
                if truncated > 0:
                    print(f"[eval] WARNING: {truncated} rect tiles truncated at the "
                          "per-Gaussian slot cap during eval; raise "
                          "max_tiles_per_gaussian for full fidelity")
                return out.image.clamp(0.0, 1.0)
            new_m = int(budget[0] * 1.5 + CHUNK - 1) // CHUNK * CHUNK
            # P*K slots exist in total, so the budget can always reach clean
            new_m = min(new_m, gm.capacity * cfg.max_tiles_per_gaussian)
            print(f"[eval] splat budget overflow ({lost} entries lost): budget grows "
                  f"{budget[0]} -> {new_m}, re-rendering")
            budget[0] = new_m
            trace.count("eval.rerenders")

    def run_split(names: List[str], view: Callable[[int], tuple]) -> Dict[str, Optional[float]]:
        per_view = []
        for i, name in enumerate(names):
            with trace.span("eval.view", name):
                with trace.span("eval.inputs"):
                    cam, gt = view(i)
                rendered = render_clean(cam)
                with trace.span("eval.score"):
                    m = [losses.psnr(rendered, gt), losses.ssim(rendered, gt)]
                    if lpips is not None:
                        m.append(lpips(rendered[None], gt[None])[0])
                    per_view.append(torch.stack(m))
                if save_images and result_path:
                    with trace.span("eval.save"):
                        _save_image_pair(result_path, f"{name}.png", rendered, gt)
        if not per_view:
            return {}
        # one fetch per split
        vals = np.asarray(trace.sync("split", torch.Tensor.tolist, torch.stack(per_view)),
                          np.float64)
        # PSNR, SSIM and LPIPS are the reference's three headline metrics:
        # lpips is None, never absent, when there are no weights
        return {"psnr": float(np.mean(vals[:, 0])), "ssim": float(np.mean(vals[:, 1])),
                "lpips": float(np.mean(vals[:, 2])) if lpips is not None else None}

    def train_view(i):
        return engine.kf_buffer.camera(intr, i), engine.kf_buffer.images[i].float() / 255.0

    def test_view(i):
        tc = engine.test_cameras[i]
        gt = trace.upload(tc.image_u8, device=dev).permute(2, 0, 1).float() / 255.0
        return make_camera(intr, tc.R_wc, tc.t_wc, device=dev), gt

    results: Dict[str, Optional[float]] = {}
    for split, names, view in (("train", engine._kf_names, train_view),
                               ("test", [tc.name for tc in engine.test_cameras], test_view)):
        for k, v in run_split(names, view).items():
            results[f"{split}_{k}"] = v
    return results
