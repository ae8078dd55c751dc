"""Port parity: tile binning. The same projected inputs go to both packages'
`bin_gaussians`; every output must match EXACTLY (integer bookkeeping: the
keys, the stable sort order and the budget cut leave no rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t

from gaussian_lic_tpu.camera import Intrinsics, look_at, make_camera
from gaussian_lic_tpu.ops import tiles as jtiles
from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD, project_gaussians
from gaussian_lic_tpu_torch.ops import tiles as ttiles

FIELDS = ("sorted_gauss", "tile_starts", "tile_lens", "cnt", "num_valid",
          "overflow", "budget_lost", "truncated", "tiles_touched")


def binning_inputs(rng, m, width=256, height=64, tied=False):
    """Projected inputs of a random scene (numpy). With `tied`, depths are
    drawn from 4 values plus copies 1 ulp apart, so many entries share a
    truncated depth key and the order falls to the k-major slot id."""
    intr = Intrinsics(width=width, height=height, fx=80.0, fy=80.0,
                      cx=width / 2, cy=height / 2)
    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    cam = make_camera(intr, R_wc, t_wc)
    xyz = np.stack([rng.uniform(-6, 6, m), rng.uniform(-1.5, 1.5, m),
                    rng.uniform(3, 10, m)], 1).astype(np.float32)
    scale = (np.abs(rng.normal(size=(m, 3))) * 0.3 + 0.05).astype(np.float32)
    quat = rng.normal(size=(m, 4)).astype(np.float32)
    opacity = rng.uniform(0.002, 0.95, m).astype(np.float32)
    p = project_gaussians(jnp.asarray(xyz), jnp.asarray(scale), jnp.asarray(quat), cam)
    depth = np.asarray(p.depth)
    if tied:
        base = rng.choice(np.array([4.0, 4.0001, 5.5, 7.25], np.float32), m)
        depth = np.where(rng.uniform(size=m) < 0.5, base,
                         np.nextafter(base, np.float32(100))).astype(np.float32)
    active = np.asarray(p.in_front & p.det_valid) & (opacity >= OPACITY_THRESHOLD)
    active[::7] = False   # some inactive (e.g. past the map's count)
    radius = np.where(active, np.asarray(p.radius), 0.0).astype(np.float32)
    return dict(xy=np.asarray(p.xy), depth=depth, conic=np.asarray(p.conic),
                opacity=opacity, radius=radius, active=active)


def both(inp, grid_args, **kw):
    jgrid = jtiles.TileGrid(*grid_args)
    tgrid = ttiles.TileGrid(*grid_args)
    names = ("xy", "depth", "conic", "opacity", "radius", "active")
    jb = jtiles.bin_gaussians(*(jnp.asarray(inp[k]) for k in names), jgrid, **kw)
    tb = ttiles.bin_gaussians(*(t(inp[k]) for k in names), tgrid, **kw)
    return jb, tb


def assert_same(jb, tb):
    for f in FIELDS:
        a, b = n(getattr(tb, f)), n(getattr(jb, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=f)


GRIDS = [(256, 64, 32, 32), (256, 64, 128, 8)]


class TestBinningParity:
    @pytest.mark.parametrize("grid", GRIDS)
    def test_random_scene(self, rng, grid):
        inp = binning_inputs(rng, 300)
        jb, tb = both(inp, grid, max_tiles_per_gaussian=16, max_total_splats=1 << 13,
                      align=256)
        assert int(tb.budget_lost) == 0
        assert int(tb.num_valid) > 200
        assert_same(jb, tb)

    def test_tied_depths(self, rng):
        inp = binning_inputs(rng, 400, tied=True)
        jb, tb = both(inp, GRIDS[0], max_tiles_per_gaussian=16,
                      max_total_splats=1 << 13, align=256)
        gauss, starts, lens = n(tb.sorted_gauss), n(tb.tile_starts), n(tb.tile_lens)
        # the case is live: some tile holds entries of equal depth
        ties = sum(
            int(np.sum(np.diff(inp["depth"][gauss[s:s + ln]]) == 0))
            for s, ln in zip(starts, lens)
        )
        assert ties > 10
        assert_same(jb, tb)

    def test_budget_overflow(self, rng):
        """A budget below the live entries: the list is cut and `cnt` takes
        the (key, slot) boundary compare (tiles.py:341-357)."""
        inp = binning_inputs(rng, 300)
        jb, tb = both(inp, GRIDS[0], max_tiles_per_gaussian=16, max_total_splats=200,
                      align=256)
        assert int(tb.budget_lost) > 0
        assert int(n(tb.cnt).sum()) == 200
        assert_same(jb, tb)

    def test_truncated_rects(self, rng):
        inp = binning_inputs(rng, 200)
        inp["radius"] = np.where(inp["active"], inp["radius"] * 4, 0).astype(np.float32)
        jb, tb = both(inp, GRIDS[0], max_tiles_per_gaussian=2,
                      max_total_splats=1 << 12, align=256)
        assert int(tb.truncated) > 0
        assert_same(jb, tb)

    def test_depth_key_and_rank_bits(self, rng):
        d = rng.uniform(0.2, 1e4, 1000).astype(np.float32)
        for tiles in (4, 320, 1200):
            bits = jtiles.rank_bits_for(tiles)
            assert ttiles.rank_bits_for(tiles) == bits
            np.testing.assert_array_equal(
                n(ttiles.depth_key(t(d), bits)),
                np.asarray(jtiles.depth_key(jnp.asarray(d), bits)).astype(np.int64),
            )
