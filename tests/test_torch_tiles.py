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


def band_inputs(rng, imbalanced):
    """Projected inputs at 256x128; `imbalanced` squeezes every mean into one
    band's rows, so the other bands get only the footprints' overhang."""
    inp = binning_inputs(rng, 300, width=256, height=128)
    if imbalanced:
        inp["xy"] = inp["xy"].copy()
        inp["xy"][:, 1] = 112.0 + 0.05 * (inp["xy"][:, 1] - 64.0)
    return inp


class TestBandBinning:
    """bin_gaussians of one band (band_ty0, band_n_ty) against JAX's, every
    output exactly, for each band of 2 and 4 bands: band-local tile ids, the
    slots outside the band dead, the band's truncation count and depth bits."""

    @pytest.mark.parametrize("imbalanced", [False, True], ids=["spread", "imbalanced"])
    @pytest.mark.parametrize("n_bands", [2, 4])
    @pytest.mark.parametrize("tile", [(32, 32), (8, 128)], ids=["32x32", "8x128"])
    def test_each_band(self, rng, n_bands, imbalanced, tile):
        inp = band_inputs(rng, imbalanced)
        grid = (256, 128, tile[1], tile[0])
        band_n_ty = ttiles.TileGrid(*grid).n_ty // n_bands
        lens = []
        for b in range(n_bands):
            jb, tb = both(inp, grid, max_tiles_per_gaussian=4, max_total_splats=1 << 12,
                          band_ty0=b * band_n_ty, band_n_ty=band_n_ty, align=256)
            assert_same(jb, tb)
            assert tb.tile_starts.shape == (band_n_ty * grid[0] // tile[1],)
            lens.append(int(tb.num_valid))
        assert min(lens) >= 0 and sum(lens) > 0
        if imbalanced:
            assert min(lens) < max(lens) // 2   # the bottom band holds most
        full = ttiles.bin_gaussians(*(t(inp[k]) for k in ("xy", "depth", "conic", "opacity",
                                                          "radius", "active")),
                                    ttiles.TileGrid(*grid), max_tiles_per_gaussian=4,
                                    max_total_splats=1 << 12)
        assert sum(lens) <= int(full.num_valid) + int(full.truncated)

    def test_truncation_is_counted_per_band(self, rng):
        inp = band_inputs(rng, False)
        inp["radius"] = np.where(inp["active"], inp["radius"] * 4, 0).astype(np.float32)
        grid = (256, 128, 32, 32)
        total = 0
        for b in range(2):
            jb, tb = both(inp, grid, max_tiles_per_gaussian=2, max_total_splats=1 << 12,
                          band_ty0=2 * b, band_n_ty=2, align=256)
            assert_same(jb, tb)
            total += int(tb.truncated)
        assert total > 0

    def test_global_tile_ids_without_a_band(self, rng):
        """compute_slot_keys_kmajor without a band keeps global tile ids, the
        form the sharded binning routes by."""
        inp = band_inputs(rng, False)
        names = ("xy", "depth", "conic", "opacity", "radius", "active")
        grid = (256, 128, 32, 32)
        jgrid, tgrid = jtiles.TileGrid(*grid), ttiles.TileGrid(*grid)
        bits = ttiles.rank_bits_for(tgrid.num_tiles)
        j = {k: jnp.asarray(inp[k]) for k in names}
        tt = {k: t(inp[k]) for k in names}
        jlive = j["active"] & (j["radius"] > 0)
        tlive = tt["active"] & (tt["radius"] > 0)
        jk, jtt, jtr = jtiles.compute_slot_keys_kmajor(
            j["xy"], jtiles.depth_key(j["depth"], bits), j["conic"], j["opacity"],
            j["radius"], jlive, jgrid, 4, bits)
        tk, ttt, ttr = ttiles.compute_slot_keys_kmajor(
            tt["xy"], ttiles.depth_key(tt["depth"], bits), tt["conic"], tt["opacity"],
            tt["radius"], tlive, tgrid, 4, bits)
        np.testing.assert_array_equal(n(tk), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(n(ttt), np.asarray(jtt))
        assert int(ttr) == int(jtr)
        live = n(tk)[n(tk) != ttiles.INVALID_KEY]
        assert (live >> bits).max() >= tgrid.n_tx * 2   # ids past the first band
