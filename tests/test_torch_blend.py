"""Port parity: the blend kernels K1/K2 and the tiled renderer.

(a) The plain K1/K2 against the JAX package's Pallas kernels on the golden
    splat list (tests/torch_goldens/blend.npz; `live` re-runs the JAX side in
    interpret mode). Image and final_T atol 1e-5 (float32 sums taken in a
    different order); n_contrib exact; per-entry gradients 1e-4 relative to
    the max (PARITY.md C12). K2's per-Gaussian result against np.add.at of
    the golden's per-entry grads over seeded ids: 1e-6 of the max.
(b) The port's render_tiled against the JAX dense oracle `render_dense`, with
    the tolerances the JAX package holds its own tiled path to
    (tests/test_rasterize_tiled.py:136-149): the tiled path restricts each
    Gaussian to its culled tiles, the oracle does not.
(c) Gradients of all six parameter groups through render_tiled against JAX
    AD of the dense oracle, <= 1e-4 relative (test_rasterize_tiled.py:199-233),
    and the blend's own VJP against JAX's `_make_blend` VJP, 1e-4 relative.
(d) The cull of K1 and K2 (`blend.warp_cull_keep`, the plain emulation of
    the footprint test both run per entry and warp block): on the golden, on
    rows at the edges of the rule and at every tile shape of 1024 pixels
    (1x1024 to 1024x1), no pair the plain arithmetic applies lies in a
    skipped block, so the plain forward with the skipped pairs left untested
    is the plain forward bit for bit, and so is the plain backward that
    walks only the kept pairs (on the golden, the NaN-opacity rows and every
    tile shape). The plain K1 and K2 against the Pallas kernels at every tile
    shape (tile_shapes golden), at (a)'s tolerances.
(e) The CUDA kernels against their plain versions, on the card only: K1 bit
    for bit on the golden, the edge rows, tiles of many staged batches, at
    every tile shape of 1024 pixels and with NaN-opacity rows; K2 per column
    on the same.
(f) NaN opacity: the plain forward and backward skip a NaN-opacity row as
    the Pallas kernels do (the nan_row golden), and the row changes nothing.

JAX is imported inside the tests that use it, so the card tests collect on a
machine without it (GLIC_TEST_TPU=1 keeps tests/conftest.py from importing it).
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    GOLDEN_SOURCES, cuda_device, golden_tool, load_golden, n, rel_max, t,
)

from gaussian_lic_tpu_torch import camera as tcam
from gaussian_lic_tpu_torch.ops import blend
from gaussian_lic_tpu_torch.ops.rasterize import render_tiled
from gaussian_lic_tpu_torch.utils.synthetic import nan_opacity_list

IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4
PER_GAUSS_RTOL = 1e-6   # per-Gaussian sums of the plain per-entry grads vs the golden's


@pytest.fixture(scope="module", params=GOLDEN_SOURCES)
def golden(request):
    return load_golden("blend", request.param)


def golden_args(d, device="cpu"):
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])
    args = (t(d["splats"]).to(device), t(d["tile_starts"]).to(device),
            t(d["tile_lens"]).to(device))
    return args, dict(n_tx=n_tx, n_ty=n_ty, tile_h=th, tile_w=tw)


def pixel_args(d, device="cpu"):
    """K2's per-pixel inputs of the golden: dL/dpix, final_T, n_contrib."""
    return [t(d[k]).to(device) for k in ("dl_dcolor", "final_t", "n_contrib")]


N_GAUSS = 300   # P of the seeded entry -> Gaussian map below


def golden_ids(d):
    """A seeded entry -> Gaussian map over the golden's list, ids in [0, P]:
    every 7th entry carries the dead id P."""
    ids = np.random.default_rng(11).integers(0, N_GAUSS, d["splats"].shape[0]).astype(np.int32)
    ids[::7] = N_GAUSS
    return ids


def per_gaussian_golden(d, ids):
    """np.add.at of the JAX golden's per-entry grads, the dead id's row dropped."""
    out = np.zeros((N_GAUSS + 1, d["entry_grads"].shape[1]), np.float64)
    np.add.at(out, ids, d["entry_grads"].astype(np.float64))
    return out[:N_GAUSS]


# --------------------------------------------------------------------- (a)

class TestPlainAgainstPallas:
    def test_forward(self, golden):
        args, kw = golden_args(golden)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, **kw)
        assert (golden["final_t"] < 1e-3).sum() > 0, "golden scene has no terminated pixel"
        np.testing.assert_allclose(n(color), golden["color"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(n(final_t), golden["final_t"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(n(n_contrib), golden["n_contrib"])

    def test_forward_no_color(self, golden):
        args, kw = golden_args(golden)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, no_color=True, **kw)
        np.testing.assert_allclose(n(final_t), golden["final_t_no_color"], atol=IMG_ATOL,
                                   rtol=0)
        assert float(color.abs().max()) == 0.0 and int(n_contrib.abs().max()) == 0

    def test_backward(self, golden):
        args, kw = golden_args(golden)
        grads = blend.blend_backward_plain(
            *args, t(golden["dl_dcolor"]), t(golden["final_t"]), t(golden["n_contrib"]), **kw
        )
        ref = golden["entry_grads"]
        assert rel_max(n(grads), ref) < GRAD_RTOL
        for i in range(blend.N_ATTR):
            assert rel_max(n(grads)[:, i], ref[:, i]) < GRAD_RTOL, i

    def test_backward_per_gaussian(self, golden):
        """K2's plain version (per-entry grads, then the per-Gaussian sum)
        against np.add.at of the Pallas per-entry grads: 1e-6 of the max."""
        args, kw = golden_args(golden)
        ids = golden_ids(golden)
        grads = blend.blend_backward(*args, *pixel_args(golden), t(ids), n_gauss=N_GAUSS, **kw)
        ref = per_gaussian_golden(golden, ids)
        assert grads.shape == (N_GAUSS, blend.N_ATTR)
        assert np.abs(ref).max() > 0 and (ids == N_GAUSS).any()
        assert rel_max(n(grads), ref) <= PER_GAUSS_RTOL


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        d = load_golden("blend", "file")
        args, kw = golden_args(d)
        before = dict(blend.LAUNCHES)
        out = blend.blend_forward(*args, **kw)
        ref = blend.blend_forward_plain(*args, **kw)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        ids = t(golden_ids(d))
        g = blend.blend_backward(*args, t(d["dl_dcolor"]), out[1], out[2], ids,
                                 n_gauss=N_GAUSS, **kw)
        per_entry = blend.blend_backward_plain(*args, t(d["dl_dcolor"]), out[1], out[2], **kw)
        assert torch.equal(g, blend.sum_per_gaussian(per_entry, ids, N_GAUSS))
        assert blend.LAUNCHES == before   # the plain version is not a launch

    @pytest.mark.parametrize("bad", ["dtype", "width", "tiles", "tile_shape", "strided"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        d = load_golden("blend", "file")
        (sp, st, ln), kw = golden_args(d)
        if bad == "dtype":
            sp = sp.double()
        elif bad == "width":
            sp = sp[:, :9]
        elif bad == "tiles":
            st = st[:-1]
        elif bad == "strided":
            ln = torch.stack([ln, ln], 1)[:, 0]
        else:
            kw = dict(kw, tile_h=16)
        with pytest.raises(ValueError):
            blend.blend_forward(sp, st, ln, **kw)

    @pytest.mark.parametrize("bad", ["ids_dtype", "ids_length", "n_gauss", "n_contrib_dtype"])
    def test_backward_rejects_what_the_kernel_does_not_take(self, bad):
        d = load_golden("blend", "file")
        args, kw = golden_args(d)
        pix = pixel_args(d)
        ids = t(golden_ids(d))
        kw = dict(kw, n_gauss=N_GAUSS)
        if bad == "ids_dtype":
            ids = ids.long()
        elif bad == "ids_length":
            ids = ids[:-1]
        elif bad == "n_gauss":
            kw["n_gauss"] = -1
        else:
            pix[2] = pix[2].long()
        with pytest.raises(ValueError):
            blend.blend_backward(*args, *pix, ids, **kw)

    def test_longest_first_orders_every_tile_once(self, rng):
        lens = torch.as_tensor(rng.integers(0, 6, 40), dtype=torch.int32)
        order = blend.longest_first(lens)
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(40))       # every tile exactly once
        got = lens[order.long()].tolist()
        assert got == sorted(lens.tolist(), reverse=True)      # longest first
        for a, b in zip(order.tolist(), order.tolist()[1:]):   # ties keep tile order
            if lens[a] == lens[b]:
                assert a < b


# --------------------------------------------------------------------- (b), (c)

W, H = 256, 64
T_INTR = tcam.Intrinsics(width=W, height=H, fx=80.0, fy=80.0, cx=128.0, cy=32.0)


def cams():
    from gaussian_lic_tpu import camera as jcam

    j_intr = jcam.Intrinsics(width=W, height=H, fx=80.0, fy=80.0, cx=128.0, cy=32.0)
    R_wc, t_wc = jcam.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    return jcam.make_camera(j_intr, R_wc, t_wc), tcam.make_camera(T_INTR, R_wc, t_wc)


def random_scene(rng, m, opa_range=(0.2, 0.9)):
    """The scene recipe of tests/test_rasterize_tiled.py, as numpy."""
    xyz = np.concatenate([rng.uniform(-6, 6, (m, 1)), rng.uniform(-1, 1, (m, 1)),
                          rng.uniform(3, 10, (m, 1))], axis=1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.08 + 0.03).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    opacity = rng.uniform(*opa_range, m).astype(np.float32)
    dc = (rng.normal(size=(m, 3)) * 0.4).astype(np.float32)
    shr = (rng.normal(size=(m, 15, 3)) * 0.05).astype(np.float32)
    return xyz, scale, quat, opacity, dc, shr


def render_both(scene, **kw):
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.rasterize_ref import render_dense

    jc, tc = cams()
    xyz, scale, quat, opacity, dc, shr = scene
    dense = render_dense(*(jnp.asarray(a) for a in (xyz, scale, quat, opacity)), jc,
                         dc=jnp.asarray(dc), sh_rest=jnp.asarray(shr), **kw)
    tiled = render_tiled(t(xyz), t(scale), t(quat), t(opacity), tc, dc=t(dc),
                         sh_rest=t(shr), max_total_splats=1 << 14, **kw)
    return dense, tiled


class TestRenderAgainstDense:
    def test_matches_dense(self, rng):
        dense, tiled = render_both(random_scene(rng, 200))
        assert int(tiled.overflow) == 0
        di, ti = n(dense.image), n(tiled.image)
        assert np.abs(di - ti).max() < 0.02
        assert np.abs(di - ti).mean() < 1e-4
        np.testing.assert_array_equal(n(dense.visible), n(tiled.visible))
        np.testing.assert_allclose(n(dense.radii), n(tiled.radii))
        assert np.abs(n(dense.final_T) - n(tiled.final_T)).max() < 0.03

    def test_no_color_alpha_only(self, rng):
        dense, tiled = render_both(random_scene(rng, 100), no_color=True)
        assert float(tiled.image.abs().max()) == 0.0
        assert np.abs(n(dense.final_T) - n(tiled.final_T)).max() < 0.03

    def test_active_mask_and_exposure(self, rng):
        xyz, scale, quat, opacity, dc, shr = (t(a) for a in random_scene(rng, 50))
        _, tc = cams()
        kw = dict(dc=dc, sh_rest=shr, max_total_splats=1 << 14)
        out = render_tiled(xyz, scale, quat, opacity, tc, active=torch.arange(50) < 25, **kw)
        ref = render_tiled(xyz[:25], scale[:25], quat[:25], opacity[:25], tc,
                           dc=dc[:25], sh_rest=shr[:25], max_total_splats=1 << 14)
        np.testing.assert_allclose(n(out.image), n(ref.image), atol=1e-5)
        assert not bool(out.visible[25:].any())
        exposure = torch.tensor(np.concatenate([np.diag([0.5, 1.0, 2.0]),
                                                np.full((3, 1), 0.1)], 1), dtype=torch.float32)
        base = render_tiled(xyz, scale, quat, opacity, tc, **kw)
        exposed = render_tiled(xyz, scale, quat, opacity, tc, exposure=exposure,
                               apply_exposure=True, **kw)
        expect = n(base.image) * np.array([0.5, 1.0, 2.0])[:, None, None] + 0.1
        np.testing.assert_allclose(n(exposed.image), expect, atol=1e-5)


class TestGradientsAgainstDense:
    def test_grad_parity_with_dense_ad(self, rng):
        import jax
        import jax.numpy as jnp

        from gaussian_lic_tpu.ops.rasterize_ref import render_dense

        xyz, scale, quat, opacity, dc, shr = random_scene(rng, 60, opa_range=(0.2, 0.8))
        params = dict(xyz=xyz, log_scale=np.log(scale), quat=quat,
                      opa_logit=np.log(opacity / (1 - opacity)), dc=dc, sh_rest=shr)
        target = rng.uniform(size=(3, H, W)).astype(np.float32)
        jc, tc = cams()

        def jloss(p):
            out = render_dense(p["xyz"], jnp.exp(p["log_scale"]), p["quat"],
                               jax.nn.sigmoid(p["opa_logit"]), jc, dc=p["dc"],
                               sh_rest=p["sh_rest"], sh_degree=3)
            return jnp.mean((out.image - jnp.asarray(target)) ** 2)

        g_dense = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
        tp = {k: t(v).requires_grad_() for k, v in params.items()}
        out = render_tiled(tp["xyz"], torch.exp(tp["log_scale"]), tp["quat"],
                           torch.sigmoid(tp["opa_logit"]), tc, dc=tp["dc"],
                           sh_rest=tp["sh_rest"], sh_degree=3, max_total_splats=1 << 14)
        loss = ((out.image - t(target)) ** 2).mean()
        g_tiled = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
        for k in params:
            assert rel_max(n(g_tiled[k]), n(g_dense[k])) < GRAD_RTOL, k


class TestBlendVjpAgainstJax:
    """The port's `_Blend` VJP (K2 then the per-Gaussian sum) against the JAX
    package's `rasterize._make_blend` VJP (Pallas K2, then its carry-sort
    reduction) on the blend golden's rows: d_rows (P, 16) within 1e-4 of each
    column's max. With the committed golden, JAX's two Pallas calls are
    replaced by their recorded interpret-mode outputs, so its own reduction
    runs on them; `live` runs them in interpret mode (minutes)."""

    @pytest.mark.parametrize("source", GOLDEN_SOURCES)
    def test_d_rows(self, source, monkeypatch):
        import jax
        import jax.numpy as jnp

        from gaussian_lic_tpu.ops import blend_pallas as jbp
        from gaussian_lic_tpu.ops import rasterize as jr
        from gaussian_lic_tpu_torch.ops import rasterize as tr
        from gaussian_lic_tpu_torch.ops import tiles as ttiles

        d = load_golden("blend", "file")
        tool = golden_tool()
        rows, b, grid, _ = tool.blend_rows()
        sw = dict(n_tx=grid.n_tx, n_ty=grid.n_ty, tile_h=32, tile_w=32)
        dl_t = jbp.swizzle_tiles(jnp.asarray(d["dl_dcolor"]), **sw)
        if source == "file":
            recorded = tuple(jbp.swizzle_tiles(jnp.asarray(d[k]), **sw)
                             for k in ("color", "final_t", "n_contrib"))
            entry = jnp.zeros((jbp.SPLAT_ROWS, d["splats"].shape[0]), jnp.float32)
            entry = entry.at[:blend.N_ATTR].set(jnp.asarray(d["entry_grads"]).T)
            monkeypatch.setattr(jr, "blend_forward", lambda *a, **k: recorded)
            monkeypatch.setattr(jr, "blend_backward", lambda *a, **k: entry)
        jblend = jr._make_blend(grid.n_tx, grid.n_ty, 32, 32, tool.BLEND_BUDGET, 16,
                                interpret=True)
        _, pull = jax.vjp(lambda r: jblend(r, b.sorted_gauss, b.tile_starts, b.tile_lens,
                                           b.cnt)[0], rows)
        want = n(pull(dl_t)[0])

        rows_t = t(rows).requires_grad_()
        tgrid = ttiles.TileGrid(width=64, height=64, tile_w=32, tile_h=32)
        color, _, _ = tr._Blend.apply(rows_t, t(b.sorted_gauss), t(b.tile_starts),
                                      t(b.tile_lens), tgrid)
        got = n(torch.autograd.grad(color, rows_t, t(d["dl_dcolor"]))[0])
        assert got.shape == want.shape == (rows.shape[0], blend.SPLAT_ROWS)
        assert np.abs(want).max() > 0
        for i in range(blend.N_ATTR):
            assert rel_max(got[:, i], want[:, i]) < GRAD_RTOL, i
        assert not got[:, blend.N_ATTR:].any()


# --------------------------------------------------------------------- (d)

def contrib_outside_keep(splats, starts, lens, kw):
    """(warp_cull_keep's mask, the count of (entry, pixel) pairs the plain
    arithmetic applies that lie in a block the mask skips)."""
    keep = blend.warp_cull_keep(splats, starts, lens, **kw)
    blocks = blend._pixel_blocks(kw["tile_h"], kw["tile_w"], splats.device)
    bad = 0
    for tiles, L in blend._tile_chunks(lens):
        e, _, valid = blend._gather_entries(splats, starts, lens, tiles, L)
        px, py = blend._pixel_coords(tiles, kw["n_tx"], kw["tile_h"], kw["tile_w"])
        contrib = blend._alpha(e, px, py)[5] & valid[..., None]
        bad += int((contrib & ~keep[tiles, :L][:, :, blocks]).sum())
    return keep, bad


THR = np.float32(1.0 / 255.0)


def _row(x, y, A, B, C, opa):
    return [x, y, A, B, C, opa, 0.2, 0.5, 0.8] + [0.0] * (blend.SPLAT_ROWS - blend.N_ATTR)


def block_of(x, y):
    """K1's warp block (row-major in the tile) that holds pixel (x, y) of tile 0."""
    return int(blend._pixel_blocks(32, 32, "cpu")[y * 32 + x])


def _at_threshold_rows():
    """A = C = 0.5, opa 0.5: the alpha = 1/255 circle has radius
    2 sqrt(ln 127.5) ~ 4.4; centres put pixel (15, 5) within a few 1e-6 of
    it on either side, the centre itself ~(19.4, 5), in another block."""
    r = 2.0 * np.sqrt(np.log(255.0 * np.float64(np.float32(0.5))))
    return [_row(15.0 + r * (1.0 + k * 1e-6), 5.0, 0.5, 0.0, 0.5, 0.5) for k in range(-20, 21)]


# rows at the edges of the cull rule, each listed in every tile of a 64x64 image
EDGE_CASES = {
    "opacity_above": [_row(10.0, 5.0, 0.5, 0.0, 0.5, THR * np.float32(1.00001))],
    "opacity_at": [_row(10.0, 5.0, 0.5, 0.0, 0.5, THR)],
    "opacity_below": [_row(10.0, 5.0, 0.5, 0.0, 0.5, np.nextafter(THR, np.float32(0)))],
    "opacity_far_below": [_row(10.0, 5.0, 0.5, 0.0, 0.5, THR * np.float32(0.99999))],
    "power_at_threshold": _at_threshold_rows(),
    "det_zero": [_row(20.0, 20.0, 1.0, 1.0, 1.0, 0.8)],
    "det_negative": [_row(20.0, 20.0, 1.0, 2.0, 1.0, 0.8)],
    "a_negative": [_row(20.0, 20.0, -1.0, 0.0, -1.0, 0.8)],
    "nonfinite_conic": [_row(20.0, 20.0, np.nan, 0.0, 1.0, 0.8),
                        _row(20.0, 20.0, np.inf, 0.0, 1.0, 0.8),
                        _row(20.0, 20.0, 1.0, np.inf, 1.0, 0.8),
                        _row(20.0, 20.0, 1.0, 0.0, -np.inf, 0.8)],
    "centre_on_block_edge": [_row(16.0, 16.0, 4.0, 0.0, 4.0, 0.9),
                             _row(15.5, 15.5, 4.0, 0.0, 4.0, 0.9),
                             _row(16.0, 16.0, 0.02, 0.01, 0.03, 0.9)],
}
NEVER_CULLED = ("det_zero", "det_negative", "a_negative", "nonfinite_conic")


def edge_scene(rows, device="cpu"):
    """`rows` listed in each of the 4 tiles of a 64x64 image."""
    sp = torch.tensor(np.asarray(rows, np.float32), device=device)
    m = sp.shape[0]
    starts = torch.zeros(4, dtype=torch.int32, device=device)
    lens = torch.full((4,), m, dtype=torch.int32, device=device)
    return (sp, starts, lens), dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)


class TestWarpCull:
    def test_no_applied_pair_is_skipped(self, golden):
        """No pair that the plain arithmetic applies lies in a skipped block,
        so the forward that leaves the skipped pairs untested is the plain
        forward bit for bit, and that matches the Pallas golden (above)."""
        args, kw = golden_args(golden)
        keep, bad = contrib_outside_keep(*args, kw)
        assert bad == 0

    def test_kept_share_is_strictly_between_0_and_1(self, golden):
        args, kw = golden_args(golden)
        keep = blend.warp_cull_keep(*args, **kw)
        share = float(keep.sum()) / (int(args[2].sum()) * keep.shape[2])
        assert 0.0 < share < 1.0

    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_edge_rows(self, case):
        args, kw = edge_scene(EDGE_CASES[case])
        keep, bad = contrib_outside_keep(*args, kw)
        assert bad == 0
        contrib = blend._alpha(args[0][None, :, :blend.N_ATTR],
                               *blend._pixel_coords(torch.arange(4), 2, 32, 32))[5]
        if case in NEVER_CULLED:
            assert bool(keep.all())
        elif case == "opacity_far_below":
            assert not bool(keep.any())
        elif case in ("opacity_above", "opacity_at"):   # the centre pixel applies it
            assert bool(contrib[0, 0, 5 * 32 + 10]) and bool(keep[0, 0, block_of(10, 5)])
        elif case == "opacity_below":
            assert not bool(contrib.any())
        elif case == "power_at_threshold":   # pixel (15, 5) on both sides of the circle
            at = contrib[0, :, 5 * 32 + 15]
            assert bool(at.any()) and not bool(at.all())
            assert block_of(15, 5) != block_of(19, 5)
            assert bool(keep[0, :, block_of(15, 5)].all())
        else:   # the four blocks that meet at (16, 16); the small splats reach no other
            corner = sorted({block_of(x, y) for x in (15, 16) for y in (15, 16)})
            others = [b for b in range(keep.shape[2]) if b not in corner]
            assert len(corner) == 4
            assert bool(keep[0, :, corner].all()) and not bool(keep[0, :2, others].any())

    def test_cull_boxes_of_the_edge_rows(self):
        boxes = blend.cull_boxes(torch.tensor(np.asarray(
            [r for c in NEVER_CULLED for r in EDGE_CASES[c]], np.float32)))
        assert bool((boxes == torch.tensor([-np.inf, np.inf, -np.inf, np.inf])).all())
        far = blend.cull_boxes(torch.tensor(EDGE_CASES["opacity_far_below"], dtype=torch.float32))
        assert bool((far[:, 0] > far[:, 1]).all()) and bool((far[:, 2] > far[:, 3]).all())


TILES = [(1 << i, 1024 >> i) for i in range(11)]   # every tile of 1024 pixels


def tile_scene(tile, device="cpu"):
    """A seeded 1000-Gaussian scene at 256x64 binned into `tile` tiles: the
    splat list, tile ranges and ids render_tiled hands K1/K2, with a seeded
    dL/dpix."""
    from gaussian_lic_tpu_torch.utils.synthetic import splat_args

    rng = np.random.default_rng(5)
    xyz, scale, quat, opacity, dc, shr = (t(a).to(device) for a in random_scene(rng, 1000))
    R_wc, t_wc = tcam.look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    cam = tcam.make_camera(T_INTR, R_wc, t_wc, device=device)
    sc = splat_args(xyz, scale, quat, opacity, cam, dc=dc, sh_rest=shr, sh_degree=3,
                    tile_h=tile[0], tile_w=tile[1], max_total_splats=1 << 14)
    g = sc["grid"]
    kw = dict(n_tx=g.n_tx, n_ty=g.n_ty, tile_h=g.tile_h, tile_w=g.tile_w)
    dl = t(rng.normal(size=(3, g.padded_height, g.padded_width)).astype(np.float32)).to(device)
    return (sc["splats"], sc["starts"], sc["lens"]), kw, sc["sorted_gauss"], sc["n_gauss"], dl


class TestTileShapes:
    """K1 takes every tile of 1024 pixels, as the JAX package does
    (config.py's tile_h, tile_w): its warp blocks of 128 pixels come from
    the tile's shape (8x16, or as wide or as narrow as the tile asks)."""

    def test_k1_block(self):
        want = {(1, 1024): (128, 1), (2, 512): (64, 2), (4, 256): (32, 4), (8, 128): (16, 8),
                (16, 64): (8, 16), (32, 32): (8, 16), (64, 16): (8, 16), (128, 8): (8, 16),
                (256, 4): (4, 32), (512, 2): (2, 64), (1024, 1): (1, 128)}
        assert sorted(want) == sorted(TILES)
        for (th, tw), block in want.items():
            assert blend.k1_block(th, tw) == block
            assert th % block[1] == 0 and tw % block[0] == 0   # whole blocks tile the tile
            blocks = blend._pixel_blocks(th, tw, "cpu")
            assert (torch.bincount(blocks) == blend.WARP_PIX).all()   # 8 blocks of 128
        for bad in ((16, 16), (0, 1024), (3, 341)):
            with pytest.raises(ValueError, match=f"{bad[0]}x{bad[1]}"):
                blend.k1_block(*bad)

    @pytest.mark.parametrize("tile", TILES, ids=lambda s: f"{s[0]}x{s[1]}")
    def test_plain_forward_feeds_the_backward(self, tile):
        """At every tile shape the plain forward's outputs are contiguous
        images that K2's entry takes, and the per-Gaussian grads are the
        per-entry ones summed (a one-row or one-column tile left strided
        views, which blend_backward rejected)."""
        args, kw, ids, P, dl = tile_scene(tile)
        color, ft, nc = blend.blend_forward(*args, **kw)
        assert color.is_contiguous() and ft.is_contiguous() and nc.is_contiguous()
        g = blend.blend_backward(*args, dl, ft, nc, ids, n_gauss=P, **kw)
        per_entry = blend.blend_backward_plain(*args, dl, ft, nc, **kw)
        assert torch.equal(g, blend.sum_per_gaussian(per_entry, ids, P))
        assert float(g.abs().max()) > 0

    @pytest.mark.parametrize("tile", TILES, ids=lambda s: f"{s[0]}x{s[1]}")
    def test_no_applied_pair_is_skipped(self, tile):
        """The cull's plain emulation at the tile's warp blocks keeps every
        pair the plain arithmetic applies."""
        args, kw, *_ = tile_scene(tile)
        keep, bad = contrib_outside_keep(*args, kw)
        assert bad == 0 and int(args[2].sum()) > 500
        assert 0.0 < float(keep.sum()) / (int(args[2].sum()) * keep.shape[2]) < 1.0


def shape_args(d, tag, device="cpu"):
    """The tile_shapes golden's list and grid at tile shape `tag`, and the
    dL/dpix of its image."""
    n_tx, n_ty, th, tw = (int(v) for v in d[f"{tag}_grid"])
    image = str(d[f"{tag}_image"])
    args = (t(d[f"{image}splats"]).to(device), t(d[f"{tag}_tile_starts"]).to(device),
            t(d[f"{tag}_tile_lens"]).to(device))
    return args, dict(n_tx=n_tx, n_ty=n_ty, tile_h=th, tile_w=tw), \
        t(d[f"{image}dl_dcolor"]).to(device)


TILE_TAGS = [f"{th}x{tw}" for th, tw in TILES]


class TestTileShapesAgainstPallas:
    """The plain K1 and K2 against the Pallas kernels at every tile of 1024
    pixels (tile_shapes golden: 8 tiles an image, each walking the whole of
    a 160-row list), at (a)'s tolerances: image and final_T atol 1e-5,
    n_contrib exact, per-entry grads 1e-4 of each column's max."""

    @pytest.mark.parametrize("source", GOLDEN_SOURCES)
    @pytest.mark.parametrize("tag", TILE_TAGS)
    def test_forward_and_backward(self, tag, source):
        d = load_golden("tile_shapes", source)
        args, kw, dl = shape_args(d, tag)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, **kw)
        assert (d[f"{tag}_final_t"] < 1e-3).sum() > 0, "no terminated pixel"
        np.testing.assert_allclose(n(color), d[f"{tag}_color"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(n(final_t), d[f"{tag}_final_t"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(n(n_contrib), d[f"{tag}_n_contrib"])
        grads = n(blend.blend_backward_plain(*args, dl, final_t, n_contrib, **kw))
        ref = d[f"{tag}_entry_grads"]
        assert np.abs(ref).max() > 0
        for i in range(blend.N_ATTR):
            assert rel_max(grads[:, i], ref[:, i]) < GRAD_RTOL, i


class TestNanOpacity:
    """A NaN-opacity row is skipped: min(0.99, NaN) is NaN, which fails the
    alpha >= 1/255 test (JAX's jnp.minimum, the plain version's clamp_max,
    and on the card splat_alpha in csrc/blend_common.cuh). The rows of the
    nan_row golden: the blend golden's list with one in front of each tile
    (utils/synthetic.nan_opacity_list)."""

    @pytest.mark.parametrize("source", GOLDEN_SOURCES)
    def test_plain_against_pallas(self, source):
        d = load_golden("blend", "file")
        want = load_golden("nan_row", source)
        args, kw = nan_args(d)
        color, final_t, n_contrib = blend.blend_forward_plain(*args, **kw)
        np.testing.assert_allclose(n(color), want["color"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_allclose(n(final_t), want["final_t"], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(n(n_contrib), want["n_contrib"])
        grads = n(blend.blend_backward_plain(*args, t(d["dl_dcolor"]), final_t, n_contrib,
                                             **kw))
        ref = want["entry_grads"]
        np.testing.assert_array_equal(np.isnan(grads), np.isnan(ref))
        for i in range(blend.N_ATTR):
            assert rel_max(np.nan_to_num(grads[:, i]), np.nan_to_num(ref[:, i])) < GRAD_RTOL, i

    def test_the_row_changes_nothing(self):
        """With the NaN row in front of each range, the plain forward is the
        one without it, n_contrib one further along."""
        d = load_golden("blend", "file")
        args, kw = nan_args(d)
        got = blend.blend_forward_plain(*args, **kw)
        ref = blend.blend_forward_plain(*golden_args(d)[0], **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2], torch.where(ref[2] > 0, ref[2] + 1, 0))


def nan_args(d, device="cpu"):
    sp, st, ln, _ = nan_opacity_list(d["splats"], d["tile_starts"], d["tile_lens"])
    return (t(sp).to(device), t(st).to(device), t(ln).to(device)), \
        dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)


def nan_ids(d):
    """Entry -> Gaussian ids over the NaN list: the NaN rows get ids
    N_GAUSS - 4 .. N_GAUSS - 1 of their own, the others seeded below them,
    every 7th the dead id."""
    sp, _, _, nan_at = nan_opacity_list(d["splats"], d["tile_starts"], d["tile_lens"])
    ids = np.random.default_rng(13).integers(0, N_GAUSS - 4, sp.shape[0]).astype(np.int32)
    ids[::7] = N_GAUSS
    ids[nan_at] = np.arange(N_GAUSS - 4, N_GAUSS)
    return ids


class TestBackwardCull:
    """K2 culls its walk by K1's rule at K1's warp blocks: the plain backward
    with only the (entry, warp block) pairs that warp_cull_keep keeps is the
    unrestricted plain backward bit for bit (a skipped pair is one the
    arithmetic does not apply), and both match the Pallas backward (the
    goldens) at (a)'s GRAD_RTOL of each column's max. On the blend golden
    (with its final_T and n_contrib), on its list with the NaN-opacity rows
    (nan_row: the NaN rows are never culled and stay NaN, as in JAX), and at
    every tile shape of 1024 pixels (tile_shapes)."""

    @pytest.mark.parametrize("scene", ["golden", "nan_row"] + TILE_TAGS)
    def test_cull_drops_nothing_that_counts(self, scene):
        if scene == "golden":
            d = load_golden("blend", "file")
            args, kw = golden_args(d)
            pix = pixel_args(d)
            ref = d["entry_grads"]
        elif scene == "nan_row":
            d = load_golden("blend", "file")
            args, kw = nan_args(d)
            pix = [t(d["dl_dcolor"])] + list(blend.blend_forward_plain(*args, **kw)[1:])
            ref = load_golden("nan_row", "file")["entry_grads"]
        else:
            d = load_golden("tile_shapes", "file")
            args, kw, dl = shape_args(d, scene)
            pix = [dl] + list(blend.blend_forward_plain(*args, **kw)[1:])
            ref = d[f"{scene}_entry_grads"]
        keep = blend.warp_cull_keep(*args, **kw)
        kept = float(keep.sum()) / (int(args[2].sum()) * keep.shape[2])
        assert 0.0 < kept < 1.0, kept   # the cull skips pairs, and walks some
        full = n(blend.blend_backward_plain(*args, *pix, **kw))
        culled = n(blend.blend_backward_plain(*args, *pix, keep=keep, **kw))
        np.testing.assert_array_equal(culled, full)
        assert np.abs(np.nan_to_num(ref)).max() > 0
        assert np.isnan(ref).any() == (scene == "nan_row")
        for got in (culled, full):
            np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
            for i in range(blend.N_ATTR):
                assert rel_max(np.nan_to_num(got[:, i]), np.nan_to_num(ref[:, i])) < GRAD_RTOL, i

    def test_keep_restricts_the_walk(self):
        """The keep hook takes effect: dropping a pair the plain arithmetic
        applies changes the gradients."""
        d = load_golden("blend", "file")
        args, kw = golden_args(d)
        pix = pixel_args(d)
        keep = blend.warp_cull_keep(*args, **kw)
        keep[0, : int(args[2][0])] = False   # tile 0 walks nothing
        full = blend.blend_backward_plain(*args, *pix, **kw)
        culled = blend.blend_backward_plain(*args, *pix, keep=keep, **kw)
        tile0 = torch.zeros(full.shape[0], dtype=torch.bool)
        tile0[int(args[1][0]):int(args[1][0]) + int(args[2][0])] = True
        assert float(full[tile0].abs().max()) > 0
        assert not culled[tile0].any()
        assert torch.equal(culled[~tile0], full[~tile0])


# --------------------------------------------------------------------- (e)

def many_batch_tiles(d, device):
    """Tiles of 1000, 999 and 517 entries that every pixel applies (wide,
    faint splats) and an empty one: 8, 8 and 5 staged batches with odd last
    ones, so the double buffer's barriers go through many phases."""
    (sp, _, _), kw = golden_args(d, device)
    parts = [sp[:1000].clone(), sp[:999].clone(), sp[:517].clone()]
    parts[1][:, 0] += 32.0
    parts[2][:, 1] += 32.0
    for q in parts:
        q[:, 2:6] = torch.tensor([0.002, 0.0, 0.002, 0.02], device=device)
    sp = torch.cat(parts).contiguous()
    starts = torch.tensor([0, 1000, 1999, 2516], dtype=torch.int32, device=device)
    lens = torch.tensor([1000, 999, 517, 0], dtype=torch.int32, device=device)
    return (sp, starts, lens), kw


@pytest.mark.requires_cuda
class TestKernelsOnTheCard:
    """K1/K2 on the card against their plain versions on the same card."""

    def test_forward_kernels(self, cuda_device):
        """K1 bit for bit against its plain version on the golden."""
        d = load_golden("blend", "file")
        args, kw = golden_args(d, cuda_device)
        before = dict(blend.LAUNCHES)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(n(a), n(b))
        assert blend.LAUNCHES["forward"] == before["forward"] + 1
        assert blend.LAUNCHES["forward_no_color"] == before["forward_no_color"] + 1

    @pytest.mark.parametrize("scene", ["edges", "many_batches"])
    def test_forward_kernel_bit_for_bit(self, scene, cuda_device):
        """K1 against its plain version, every output bit for bit: the rows
        at the edges of the cull rule, and tiles of 1000, 999 and 517
        always-applied entries."""
        if scene == "edges":
            args, kw = edge_scene([r for rows in EDGE_CASES.values() for r in rows], cuda_device)
        else:
            args, kw = many_batch_tiles(load_golden("blend", "file"), cuda_device)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(n(a), n(b))
        if scene == "many_batches":
            assert int(out[2].max()) == 0 and int(ref[2].max()) == 0   # no_color
            assert int(blend.blend_forward(*args, **kw)[2].max()) == 1000

    def test_rejects_unaligned_splats(self, cuda_device):
        d = load_golden("blend", "file")
        (sp, st, ln), kw = golden_args(d, cuda_device)
        flat = torch.empty(sp.numel() + 1, dtype=torch.float32, device=cuda_device)
        odd = flat[1:].view(sp.shape)
        odd.copy_(sp)
        assert odd.is_contiguous() and odd.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            blend.blend_forward(odd, st, ln, **kw)

    def test_backward_kernel(self, cuda_device):
        """K2 (per-Gaussian sums with atomics) against its plain version on
        the card and against the golden."""
        d = load_golden("blend", "file")
        args, kw = golden_args(d, cuda_device)
        pix = pixel_args(d, cuda_device)
        ids = t(golden_ids(d)).to(cuda_device)
        before = blend.LAUNCHES["backward"]
        g = blend.blend_backward(*args, *pix, ids, n_gauss=N_GAUSS, **kw)
        ref = blend.sum_per_gaussian(blend.blend_backward_plain(*args, *pix, **kw), ids,
                                     N_GAUSS)
        torch.cuda.synchronize()
        assert blend.LAUNCHES["backward"] == before + 1
        for i in range(blend.N_ATTR):
            assert rel_max(n(g)[:, i], n(ref)[:, i]) < GRAD_RTOL, i
        assert rel_max(n(g), per_gaussian_golden(d, golden_ids(d))) < GRAD_RTOL

    @pytest.mark.parametrize("tile", TILES, ids=lambda s: f"{s[0]}x{s[1]}")
    def test_tile_shapes(self, tile, cuda_device):
        """K1 bit for bit (color, no_color) and K2 per column at each tile
        shape of the band geometry, against the plain versions."""
        args, kw, ids, P, dl = tile_scene(tile, cuda_device)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(n(a), n(b))
        color_p, ft, nc = blend.blend_forward_plain(*args, **kw)
        assert int(nc.max()) > 0 and float(color_p.abs().max()) > 0
        g = blend.blend_backward(*args, dl, ft, nc, ids, n_gauss=P, **kw)
        gp = blend.sum_per_gaussian(blend.blend_backward_plain(*args, dl, ft, nc, **kw), ids, P)
        torch.cuda.synchronize()
        for i in range(blend.N_ATTR):
            assert rel_max(n(g)[:, i], n(gp)[:, i]) < GRAD_RTOL, i

    def test_renders_tiles_under_8_rows(self, cuda_device):
        """A 4x256 tile (32x4 warp blocks) renders bit for bit against the
        plain version, color and no_color, on the tile_shapes golden's list."""
        d = load_golden("tile_shapes", "file")
        args, kw, _ = shape_args(d, "4x256", cuda_device)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(n(a), n(b))
        _, final_t, n_contrib = blend.blend_forward_plain(*args, **kw)
        assert int(n_contrib.max()) > 0 and bool((final_t < 1e-3).any())

    def test_nan_opacity_row(self, cuda_device):
        """K1 skips the NaN-opacity rows bit for bit as its plain version
        does; K2 skips them too: every other Gaussian's gradients agree, and
        the NaN rows' own Gaussians get no opacity or colour gradient (their
        position and conic gradients are 0 on the card and opa * 0 = NaN in
        the plain version and JAX, which take the product before the test)."""
        d = load_golden("blend", "file")
        args, kw = nan_args(d, cuda_device)
        for no_color in (False, True):
            out = blend.blend_forward(*args, no_color=no_color, **kw)
            ref = blend.blend_forward_plain(*args, no_color=no_color, **kw)
            torch.cuda.synchronize()
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(n(a), n(b))
        _, ft, nc = blend.blend_forward_plain(*args, **kw)
        ids = t(nan_ids(d)).to(cuda_device)
        dl = t(d["dl_dcolor"]).to(cuda_device)
        g = n(blend.blend_backward(*args, dl, ft, nc, ids, n_gauss=N_GAUSS, **kw))
        gp = n(blend.sum_per_gaussian(blend.blend_backward_plain(*args, dl, ft, nc, **kw),
                                      ids, N_GAUSS))
        nan_g = slice(N_GAUSS - 4, N_GAUSS)
        assert np.isfinite(g).all() and np.isnan(gp[nan_g, :5]).all()
        assert not g[nan_g].any() and not gp[nan_g, 5:].any()
        for i in range(blend.N_ATTR):
            assert rel_max(g[:N_GAUSS - 4, i], gp[:N_GAUSS - 4, i]) < GRAD_RTOL, i

    def test_backward_kernel_many_batches(self, cuda_device):
        """K2 on many_batch_tiles: the double buffer's barriers go through
        many phases."""
        d = load_golden("blend", "file")
        (sp, starts, lens), kw = many_batch_tiles(d, cuda_device)
        ids = np.random.default_rng(12).integers(0, N_GAUSS + 1, sp.shape[0]).astype(np.int32)
        ids = t(ids).to(cuda_device)
        dl = pixel_args(d, cuda_device)[0]
        _, ft, nc = blend.blend_forward(sp, starts, lens, **kw)
        g = blend.blend_backward(sp, starts, lens, dl, ft, nc, ids, n_gauss=N_GAUSS, **kw)
        ref = blend.sum_per_gaussian(blend.blend_backward_plain(sp, starts, lens, dl, ft, nc,
                                                                **kw), ids, N_GAUSS)
        torch.cuda.synchronize()
        assert int(nc.max()) == 1000
        for i in range(blend.N_ATTR):
            assert rel_max(n(g)[:, i], n(ref)[:, i]) < GRAD_RTOL, i
