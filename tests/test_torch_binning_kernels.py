"""The binning kernels K8 (`bin_keys`), K13 (`sort_live_slots`), K9
(`bin_ranges`) and K10 (`gather_splats`) of ops/tiles.py.

CPU: the plain versions against the JAX package (`gaussian_lic_tpu.ops.tiles`
and the `jnp.take` of its rasterizer), exactly (integer bookkeeping and
copies of floats). Inputs are made with numpy from a seed.
  * The int32 key map keeps the uint32 order: INVALID_KEY last, and a stable
    sort of the int32 keys is the stable sort of the uint32 keys (hypothesis).
  * K8's plain keys are JAX's `compute_slot_keys_kmajor` keys, band and global.
  * `bin_gaussians` (K8's plain keys, K13's plain sort of the live slots,
    K9's plain ranges) equals JAX's `Binning` field for field: random scenes; leading,
    inner and trailing empty tiles; a budget below the live entries (K9's
    histogram `cnt` against JAX's survivor compare); m_eff == P K; every band
    of D = 2 and 4; K = 8 and 16; edge rows (NaN opacity, radius 0,
    inactive, rects clamped at every image edge and truncated by K, a
    negative depth whose key spills into the tile field).
  * K10's plain gather equals jnp.take(..., mode="fill") with the dead id P.
  * K13's plain version (the live slots in slot order, then the stable sort)
    is the first num_valid entries of the stable sort of all P K keys, and
    K9's plain version reads the same list from it, at the live count and
    at a budget cut: heavy depth ties, dead slots interleaved, all dead,
    all live, P K not a multiple of any block; K13's geometry is the
    kernel's.

CPU, chip_smoke's helpers: the slot mask K8 evaluates and the warp-slots
of its two designs; K8's and K9's variant numbers are the kernels'. K9's
magic remainder gives n // P and n % P at the edges of its range, and
`bin_ranges` with K8's keys, touched and sums (CPU: its plain version) gives
JAX's cnt on every case.

Card (`requires_cuda`): each kernel against its plain version on the card,
bit for bit: K8 on the edge rows (and a NaN mean) at P = 1, 3, 129 and
2001, at the 11 tile shapes of 1024 pixels and a 24x40 tile (whose 1/24 is
not exact), band and global tile ids, depth and depth-key inputs, the mean
and conic as strided views of a splat table; K8's listed design on a
partial block, an all-dead block, a block of rects of K tiles or more, an
empty band, K = 1 and 16, three launches in a row; every K8 variant that
claims K8's outputs against K8; K9 and K10 on the lists K8
produces (empty tiles, a budget cut, m_eff == P K, bands); `bin_gaussians`
and the gather captured in a CUDA graph and replayed on new inputs; every
K9 variant that claims K9's outputs on every case at the budget and at a
cut, with K8's outputs and without; K9 in a CUDA graph replayed twice.
K13 against its plain version at both benchmark cells' shapes (2^20 x 16;
2^21 x 16 with a quarter of the rows dead) and the CPU cases, captured in a
CUDA graph and replayed at other live counts; `bin_gaussians` on the card,
with torch.sort made to raise, against the whole sort on the CPU of K8's
keys (budget cuts included), and captured and replayed at another live
count across a budget cut; a train step, eager and in a bundle, runs one
K13 a K8 and no torch.sort.

JAX is imported inside the tests that use it, so the card tests collect on
a machine without it.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_port_helpers import cuda_device, n, t  # noqa: F401  (cuda_device: a fixture)

from gaussian_lic_tpu_torch.ops import tiles as ttiles

FIELDS = ("sorted_gauss", "tile_starts", "tile_lens", "cnt", "num_valid",
          "overflow", "budget_lost", "truncated", "tiles_touched")
NAMES = ("xy", "depth", "conic", "opacity", "radius", "active")
TILES = [(1 << i, 1024 >> i) for i in range(11)]   # (tile_h, tile_w): every tile of 1024 pixels
EDGE_ROWS = ("nan_opacity", "radius_0", "inactive", "left", "right", "top", "bottom",
             "corner", "whole_image", "negative_depth")


def scene(rng, P, width=256, height=128, edge_rows=True, nan_mean=False):
    """Projected inputs (numpy) of P random Gaussians: means up to 10% off
    the image, EWA conics of scales 0.5-12 px (+0.3 dilation), the
    reference's radius (ceil(3 sqrt(l1))), depths 0.3-40, opacities
    0.002-0.99, 10% inactive. With `edge_rows`, rows 0, 1, .. are
    EDGE_ROWS (those that fit); with `nan_mean`, the last row's mean is NaN."""
    x = rng.uniform(-0.1, 1.1, P) * width
    y = rng.uniform(-0.1, 1.1, P) * height
    s1, s2 = rng.uniform(0.5, 12.0, P), rng.uniform(0.5, 12.0, P)
    th = rng.uniform(0.0, np.pi, P)
    c, s = np.cos(th), np.sin(th)
    a = c * c * s1 * s1 + s * s * s2 * s2 + 0.3
    b = c * s * (s1 * s1 - s2 * s2)
    cc = s * s * s1 * s1 + c * c * s2 * s2 + 0.3
    det = a * cc - b * b
    mid = 0.5 * (a + cc)
    radius = np.ceil(3.0 * np.sqrt(mid + np.sqrt(np.maximum(0.1, mid * mid - det))))
    d = dict(xy=np.stack([x, y], 1), depth=rng.uniform(0.3, 40.0, P),
             conic=np.stack([cc / det, -b / det, a / det], 1),
             opacity=rng.uniform(0.002, 0.99, P), radius=radius,
             active=rng.uniform(size=P) < 0.9)
    if edge_rows:
        rows = dict(zip(EDGE_ROWS, range(min(P, len(EDGE_ROWS)))))
        edge = {"left": (-5.0, 0.5 * height), "right": (width + 5.0, 0.5 * height),
                "top": (0.5 * width, -5.0), "bottom": (0.5 * width, height + 5.0),
                "corner": (width + 3.0, height + 3.0), "whole_image": (0.5 * width, 0.5 * height)}
        for name, r in rows.items():
            d["active"][r] = name != "inactive"
            if name in edge:
                d["xy"][r] = edge[name]
                d["radius"][r] = 3.0 * max(width, height) if name == "whole_image" else 40.0
                d["conic"][r] = (1e-4, 0.0, 1e-4)
                d["opacity"][r] = 0.9
        if "nan_opacity" in rows:
            d["opacity"][rows["nan_opacity"]] = np.nan
        if "radius_0" in rows:
            d["radius"][rows["radius_0"]] = 0.0
        if "negative_depth" in rows:
            d["depth"][rows["negative_depth"]] = -2.0
    if nan_mean:
        d["xy"][-1] = np.nan
    return {k: (v if k == "active" else v.astype(np.float32)) for k, v in d.items()}


def clustered(rng, P, width=256, height=128, tile=32):
    """Small Gaussians in two tiles only, (tx, ty) = (2, 1) and (5, 2) of
    the 32x32 grid: leading, inner and trailing tiles are empty."""
    d = scene(rng, P, width, height, edge_rows=False)
    where = rng.integers(0, 2, P)
    d["xy"] = np.stack([np.where(where, 5, 2) * tile + rng.uniform(10, 22, P),
                        np.where(where, 2, 1) * tile + rng.uniform(10, 22, P)], 1)
    d["xy"] = d["xy"].astype(np.float32)
    d["radius"] = np.full(P, 4.0, np.float32)
    d["conic"] = np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (P, 1))
    return d


def jax_binning(d, grid_args, **kw):
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops import tiles as jtiles

    return jtiles.bin_gaussians(*(jnp.asarray(d[k]) for k in NAMES),
                                jtiles.TileGrid(*grid_args), **kw)


def assert_binning_equal(got, want):
    for f in FIELDS:
        a, b = n(getattr(got, f)), n(getattr(want, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=f)


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX package
# ---------------------------------------------------------------------------

KEYS = st.lists(st.one_of(st.sampled_from([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                                           ttiles.INVALID_KEY - 1, ttiles.INVALID_KEY]),
                          st.integers(0, ttiles.INVALID_KEY)), min_size=1, max_size=64)


@settings(max_examples=200, deadline=None)
@given(KEYS)
def test_int32_keys_sort_as_uint32(keys):
    """keys_to_int32 keeps the uint32 order and its inverse restores the
    values; the stable sort of the int32 keys is the stable uint32 sort
    (equal keys keep their slot order) and INVALID_KEY sorts last."""
    u = np.array(keys, np.uint32)
    k32 = ttiles.keys_to_int32(torch.as_tensor(u.astype(np.int64)))
    assert k32.dtype == torch.int32
    np.testing.assert_array_equal(n(ttiles.keys_from_int32(k32)), u.astype(np.int64))
    np.testing.assert_array_equal(n(torch.sort(k32, stable=True).indices),
                                  np.argsort(u, kind="stable"))
    if ttiles.INVALID_KEY in keys:
        assert int(k32.max()) == (1 << 31) - 1 == int(k32[keys.index(ttiles.INVALID_KEY)])


@pytest.mark.parametrize("band", [None, (0, 2), (2, 2)], ids=["global", "band0", "band1"])
@pytest.mark.parametrize("K", [8, 16])
def test_bin_keys_plain_is_jax_keys(band, K):
    """K8's plain keys, tiles_touched and sums are JAX's
    compute_slot_keys_kmajor's (int32 keys mapped back to uint32), with the
    edge rows, globally and in a band."""
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops import tiles as jtiles

    d = scene(np.random.default_rng(3 + K), 300)
    grid = (256, 128, 32, 32)
    bits = ttiles.rank_bits_for(ttiles.TileGrid(*grid).num_tiles)
    kw = {} if band is None else dict(band_ty0=band[0], band_n_ty=band[1])
    j = {k: jnp.asarray(d[k]) for k in NAMES}
    jk, jtt, jtr = jtiles.compute_slot_keys_kmajor(
        j["xy"], jtiles.depth_key(j["depth"], bits), j["conic"], j["opacity"], j["radius"],
        j["active"] & (j["radius"] > 0), jtiles.TileGrid(*grid), K, bits,
        **({} if band is None else dict(band_ty0=jnp.int32(band[0]), band_n_ty=band[1])))
    keys, touched, sums = ttiles.bin_keys_plain(*(t(d[k]) for k in NAMES),
                                                ttiles.TileGrid(*grid), K, bits, **kw)
    assert keys.dtype == torch.int32 and keys.shape == (K * 300,)
    np.testing.assert_array_equal(n(ttiles.keys_from_int32(keys)), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(n(touched), np.asarray(jtt))
    assert n(sums).tolist() == [int(jtr), int(np.asarray(jtt).sum())]


CASES = {
    # name: (scene, grid, K, max_total_splats)
    "random_k8": ("random", (256, 128, 32, 32), 8, 1 << 13),
    "random_k16": ("random", (256, 128, 32, 32), 16, 1 << 13),
    "flat_tiles_k8": ("random", (256, 128, 128, 8), 8, 1 << 13),
    "empty_tiles_k8": ("clustered", (256, 128, 32, 32), 8, 1 << 13),
    "empty_tiles_k16": ("clustered", (256, 128, 32, 32), 16, 1 << 13),
    "overflow_k8": ("random", (256, 128, 32, 32), 8, 200),
    "overflow_k16": ("random", (256, 128, 32, 32), 16, 333),
    "m_eff_is_pk_k8": ("random", (256, 128, 32, 32), 8, 300 * 8),
    "m_eff_is_pk_k16": ("random", (256, 128, 32, 32), 16, 1 << 20),
}


def case_inputs(name, seed=0):
    kind, grid, K, M = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    d = clustered(rng, 300) if kind == "clustered" else scene(rng, 300)
    return d, grid, K, M


@pytest.mark.parametrize("name", list(CASES))
def test_bin_gaussians_plain_is_jax_binning(name):
    """The port's binning of CPU tensors (K8 plain, the stable sort of its
    live int32 keys, K9 plain) is JAX's Binning field for field."""
    d, grid, K, M = case_inputs(name)
    kw = dict(max_tiles_per_gaussian=K, max_total_splats=M, align=256)
    tb = ttiles.bin_gaussians(*(t(d[k]) for k in NAMES), ttiles.TileGrid(*grid), **kw)
    assert_binning_equal(tb, jax_binning(d, grid, **kw))
    lens, starts = n(tb.tile_lens), n(tb.tile_starts)
    if name.startswith("empty_tiles"):
        occupied = np.flatnonzero(lens)
        assert occupied[0] > 0 and occupied[-1] < lens.size - 1       # leading, trailing
        assert np.any(lens[occupied[0]:occupied[-1]] == 0)              # inner
        assert starts[-1] == int(tb.num_valid)   # an empty tile starts at the next entry
    if name.startswith("overflow"):
        assert int(tb.budget_lost) > 0 and int(n(tb.cnt).sum()) == M
        assert (n(tb.cnt) <= n(tb.tiles_touched)).all()
        assert (n(tb.cnt) < n(tb.tiles_touched)).any()
    if name.startswith("m_eff_is_pk"):
        assert tb.sorted_gauss.shape[0] == -(-300 * K // 256) * 256
        assert int(tb.budget_lost) == 0
        np.testing.assert_array_equal(n(tb.cnt), n(tb.tiles_touched))


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("D", [2, 4])
def test_every_band(D, K):
    """bin_gaussians of each band of D against JAX's, every field exactly,
    with the band's depth bits (JAX's rule)."""
    d = scene(np.random.default_rng(7 * D + K), 300)
    grid = (256, 128, 32, 32)
    band_n_ty = ttiles.TileGrid(*grid).n_ty // D
    for b in range(D):
        kw = dict(max_tiles_per_gaussian=K, max_total_splats=1 << 12, align=256,
                  band_ty0=b * band_n_ty, band_n_ty=band_n_ty)
        tb = ttiles.bin_gaussians(*(t(d[k]) for k in NAMES), ttiles.TileGrid(*grid), **kw)
        assert_binning_equal(tb, jax_binning(d, grid, **kw))


def test_bin_ranges_plain_on_jax_sorted_list():
    """K9's plain version on JAX's own sorted keys and slots (lax.sort) is
    JAX's Binning: the ranges, the ids and the survivor counts under a
    budget cut, without the port's K8 or sort."""
    import jax
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops import tiles as jtiles

    d = scene(np.random.default_rng(21), 300)
    grid, K, M = (256, 128, 32, 32), 8, 250
    jgrid = jtiles.TileGrid(*grid)
    bits = jtiles.rank_bits_for(jgrid.num_tiles)
    j = {k: jnp.asarray(d[k]) for k in NAMES}
    keys, _, _ = jtiles.compute_slot_keys_kmajor(
        j["xy"], jtiles.depth_key(j["depth"], bits), j["conic"], j["opacity"], j["radius"],
        j["active"] & (j["radius"] > 0), jgrid, K, bits, band_ty0=jnp.int32(0),
        band_n_ty=jgrid.n_ty)
    sk, ss = jax.lax.sort((keys, jnp.arange(300 * K, dtype=jnp.int32)), num_keys=1)
    m_pad = -(-M // 256) * 256
    got = ttiles.bin_ranges_plain(
        ttiles.keys_to_int32(t(np.asarray(sk).astype(np.int64))), t(np.asarray(ss), torch.int64),
        M, m_pad, 300, jgrid.num_tiles, bits)
    want = jax_binning(d, grid, max_tiles_per_gaussian=K, max_total_splats=M, align=256)
    assert int(want.budget_lost) > 0
    for f, a in zip(("sorted_gauss", "tile_starts", "tile_lens", "cnt"), got):
        np.testing.assert_array_equal(n(a), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("P", [1, 300])
def test_gather_plain_is_jnp_take(P):
    """K10's plain gather is jnp.take(rows, ids, axis=0, mode="fill") of
    the (P+1, 16) table whose last row is zero, the dead id P included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(P)
    table = np.concatenate([rng.normal(size=(P, 16)), np.zeros((1, 16))]).astype(np.float32)
    ids = rng.integers(0, P + 1, 777).astype(np.int32)
    ids[::5] = P
    got = ttiles.gather_splats_plain(t(table), t(ids))
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0, mode="fill"))
    np.testing.assert_array_equal(n(got), want)
    assert not n(got)[::5].any()


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers are their plain versions and count no
    launch."""
    d, grid, K, M = case_inputs("overflow_k8")
    g = ttiles.TileGrid(*grid)
    before = dict(ttiles.LAUNCHES)
    args = [t(d[k]) for k in NAMES]
    k = ttiles.bin_keys(*args, g, K, 20, band_n_ty=g.n_ty)
    kp = ttiles.bin_keys_plain(*args, g, K, 20, band_n_ty=g.n_ty)
    assert all(torch.equal(a, b) for a, b in zip(k, kp))
    sk, ss = torch.sort(k[0], stable=True)
    r = ttiles.bin_ranges(sk, ss, M, 256, 300, g.num_tiles, 20)
    rp = ttiles.bin_ranges_plain(sk, ss, M, 256, 300, g.num_tiles, 20)
    assert all(torch.equal(a, b) for a, b in zip(r, rp))
    table = torch.randn(301, 16)
    assert torch.equal(ttiles.gather_splats(table, r[0]), ttiles.gather_splats_plain(table, r[0]))
    assert ttiles.LAUNCHES == before


def chip_smoke():
    """chip_smoke.py as a module (its helpers run on the CPU)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_k8_warp_slots_from_the_slot_mask():
    """chip_smoke.k8_warp_slots: the first design runs the power's body in
    every (warp of 32 Gaussians, slot) where one lane evaluates the slot;
    the listed design in ceil(pairs / 32) passes for each block of 256
    Gaussians and each 8 slots."""
    cs = chip_smoke()
    ok = torch.zeros((2, 300), dtype=torch.bool)
    ok[0, :70] = True          # warps 0-2 at slot 0
    ok[1, 5] = True            # warp 0 at slot 1
    ok[0, 256:260] = True      # the second block: warp 8
    assert cs.k8_warp_slots(ok) == dict(evaluated=75, serial=5, listed=3 + 1,
                                        warps=2 * 10)
    ok = torch.zeros((16, 256), dtype=torch.bool)
    ok[:, 0] = True            # one Gaussian, 16 slots: two passes of 8 slots
    assert cs.k8_warp_slots(ok) == dict(evaluated=16, serial=16, listed=2, warps=16 * 8)
    assert cs.k8_warp_slots(torch.zeros((8, 3), dtype=torch.bool))["listed"] == 0


def test_evaluated_mask_is_the_slots_k8_evaluates():
    """chip_smoke.evaluated_mask: live, in the rect and in the band, the
    slots whose keys the plain version can keep."""
    cs = chip_smoke()
    d = scene(np.random.default_rng(4), 500)
    g = ttiles.TileGrid(256, 128, 32, 32)
    x = {k: t(v) for k, v in d.items()}
    live = x["active"] & (x["radius"] > 0)
    for band in (None, (1, 2)):
        ok = cs.evaluated_mask(x["xy"], x["radius"], live, g, 8, band)
        kw = {} if band is None else dict(band_ty0=band[0], band_n_ty=band[1])
        keys = ttiles.bin_keys_plain(*(x[k] for k in NAMES), g, 8, 20, **kw)[0]
        kept = (keys != ttiles.keys_to_int32(torch.tensor([ttiles.INVALID_KEY]))).reshape(8, -1)
        assert ok.shape == (8, 500) and bool((kept <= ok).all()) and int(ok.sum()) > int(
            kept.sum()) > 0
        assert cs.evaluated_slots(x["xy"], x["radius"], live, g, 8, band) == int(ok.sum())


def test_k8_variant_numbers_are_the_kernels():
    """ops/tiles.py K8_VARIANT_IDS holds csrc/bin_keys.cuh's K8Variant
    numbers, and only variants that compute K8's outputs have a plain
    version on the CPU."""
    import os
    import re

    from torch_port_helpers import ROOT

    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc", "bin_keys.cuh")) as f:
        enum = dict(re.findall(r"^  (kK8\w+) = (\d+),", f.read(), re.M))
    camel = {"base": "Base", "nopower": "NoPower", "onestore": "OneStore", "rcp": "Rcp",
             "vecload": "VecLoad", "notable": "NoTable", "memonly": "MemOnly", "fold": "Fold",
             "listed": "Listed", "listed_nopower": "ListedNoPower"}
    want = {k: int(enum["kK8" + v]) for k, v in camel.items()}
    assert set(enum) == {"kK8" + v for v in camel.values()}
    assert ttiles.K8_VARIANT_IDS == want
    d, grid, K, M = case_inputs("overflow_k8")
    g = ttiles.TileGrid(*grid)
    args = [t(d[k]) for k in NAMES]
    plain = ttiles.bin_keys_plain(*args, g, K, 20)
    for v in ttiles.K8_VARIANTS:
        if v in ttiles.K8_TIMING_ONLY:
            with pytest.raises(ValueError, match="timing probe"):
                ttiles.bin_keys_probe(v, *args, g, K, 20)
        else:
            got = ttiles.bin_keys_probe(v, *args, g, K, 20)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="unknown K8 variant"):
        ttiles.bin_keys_probe("fast", *args, g, K, 20)


def test_k9_variant_numbers_are_the_kernels():
    """ops/tiles.py K9_VARIANT_IDS holds csrc/bin_ranges.cuh's K9Variant
    numbers, and only variants that compute K9's outputs have a plain
    version on the CPU."""
    import os
    import re

    from torch_port_helpers import ROOT

    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc", "bin_ranges.cuh")) as f:
        enum = dict(re.findall(r"^  (kK9\w+) = (\d+),", f.read(), re.M))
    camel = {"base": "Base", "hist": "Hist", "first": "First", "memonly": "MemOnly",
             "noatomic": "NoAtomic", "mod32": "Mod32", "fastdiv": "FastDiv"}
    assert set(enum) == {"kK9" + v for v in camel.values()}
    assert ttiles.K9_VARIANT_IDS == {k: int(enum["kK9" + v]) for k, v in camel.items()}
    assert set(ttiles.K9_HISTOGRAM) == set(ttiles.K9_VARIANTS) - {"base"}
    d, grid, K, M = case_inputs("overflow_k8")
    g = ttiles.TileGrid(*grid)
    keys, touched, sums = ttiles.bin_keys_plain(*(t(d[k]) for k in NAMES), g, K, 20)
    sk, ss = torch.sort(keys, stable=True)
    plain = ttiles.bin_ranges_plain(sk, ss, M, 256, 300, g.num_tiles, 20)
    for v in ttiles.K9_VARIANTS:
        if v in ttiles.K9_TIMING_ONLY:
            with pytest.raises(ValueError, match="timing probe"):
                ttiles.bin_ranges_probe(v, sk, ss, M, 256, 300, g.num_tiles, 20)
        else:
            got = ttiles.bin_ranges_probe(v, sk, ss, M, 256, 300, g.num_tiles, 20,
                                          slot_keys=keys, touched=touched, sums=sums)
            assert all(torch.equal(a, b) for a, b in zip(got, plain))
    with pytest.raises(ValueError, match="unknown K9 variant"):
        ttiles.bin_ranges_probe("fast", sk, ss, M, 256, 300, g.num_tiles, 20)


FASTDIV_P = sorted({1, 2, 3, 7, 1_000_003, ((1 << 31) - 1) // 16}
                   | {(1 << k) + o for k in (1, 2, 4, 10, 16, 20, 26) for o in (-1, 0, 1)})


@pytest.mark.parametrize("P", FASTDIV_P)
def test_k9_fastdiv_magic(P):
    """K9's remainder: the host's magic multiplier and shift give n // P and
    n % P for n at 0, P - 1, P and P K - 1 (K = 16, the largest slot id of
    the 1M-Gaussian scale's lists), below 2^31, in K9's 32-bit arithmetic
    (a 32 x 32 -> 64-bit product, the magic below 2^32)."""
    magic, shift = ttiles.k9_fastdiv(P)
    assert 0 < magic < 1 << 32 and 31 <= shift <= 62
    for n in (0, P - 1, P, P * 16 - 1, (1 << 31) - 1):
        if n < 0 or n >= 1 << 31:
            continue
        q = (n * magic) >> shift
        assert q == n // P and (n - q * P) % (1 << 32) == n % P, n
    with pytest.raises(ValueError):
        ttiles.k9_fastdiv(0)


@pytest.mark.parametrize("name", list(CASES))
def test_bin_ranges_with_k8_outputs_on_the_cpu(name):
    """bin_ranges on CPU tensors, with K8's keys, touched and sums and
    without, is bin_ranges_plain, and its cnt is JAX's (touched where the
    budget cuts nothing, the survivor compare where it does)."""
    d, grid, K, M = case_inputs(name)
    g = ttiles.TileGrid(*grid)
    bits = ttiles.rank_bits_for(g.num_tiles)
    keys, touched, sums = ttiles.bin_keys_plain(*(t(d[k]) for k in NAMES), g, K, bits,
                                                band_n_ty=g.n_ty)
    sk, ss = torch.sort(keys, stable=True)
    m_eff = min(M, 300 * K)
    m_pad = -(-m_eff // 256) * 256
    plain = ttiles.bin_ranges_plain(sk, ss, m_eff, m_pad, 300, g.num_tiles, bits)
    for kw in ({}, dict(slot_keys=keys, touched=touched, sums=sums)):
        got = ttiles.bin_ranges(sk, ss, m_eff, m_pad, 300, g.num_tiles, bits, **kw)
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, plain))
    want = jax_binning(d, grid, max_tiles_per_gaussian=K, max_total_splats=M, align=256)
    np.testing.assert_array_equal(n(plain[3]), np.asarray(want.cnt))
    if name.startswith("overflow"):
        assert int(sums[1]) > m_eff
    else:
        np.testing.assert_array_equal(n(plain[3]), n(touched))


def live_keys(P, K, device, seed, *, dead_rows=0.0, tiles=1280, ties=64, interleaved=False,
              all_dead=False, all_live=False):
    """K8-like int32 keys of P Gaussians' K slots, k-major: a live row uses
    its first slot, and its second in one row of five (~7.5% of K = 16
    slots, as the benchmark's 1M-row step), each on one of `tiles` tiles
    with one of `ties` depth keys of 21 bits (heavy ties); `dead_rows` of the
    rows use none. `interleaved`: each slot live with probability 1/2
    wherever it lies; `all_dead`, `all_live`: every slot."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.arange(K, device=device)[:, None]
    if all_dead or all_live:
        live = torch.full((K, P), all_live, dtype=torch.bool, device=device)
    elif interleaved:
        live = torch.rand((K, P), generator=g, device=device) < 0.5
    else:
        used = 1 + (torch.rand(P, generator=g, device=device) < 0.2).long()
        used[torch.rand(P, generator=g, device=device) < dead_rows] = 0
        live = k < used[None]
    tile = torch.randint(0, tiles, (K, P), generator=g, device=device)
    depth = torch.randint(0, ties, (K, P), generator=g, device=device) * 32767 % (1 << 21)
    keys = torch.where(live, (tile << 21) | depth, ttiles.INVALID_KEY)
    return ttiles.keys_to_int32(keys.reshape(-1))


SORT_CASES = {
    # name: (P, K, live_keys' keywords)
    "ties": (3000, 8, dict(tiles=4, ties=2)),
    "interleaved": (5000, 8, dict(interleaved=True)),
    "all_dead": (4096, 16, dict(all_dead=True)),
    "all_live": (65537, 16, dict(all_live=True)),
    "odd_size": (1237, 7, dict(dead_rows=0.3)),
    "one_slot": (1, 1, {}),
}
# the benchmark cells' shapes: fastlivo's 2^20 rows, r3live_indoor's 2^21
# with a quarter of them dead (K = 16)
CELL_SORT_CASES = {
    "fastlivo": (1 << 20, 16, {}),
    "r3live_indoor": (1 << 21, 16, dict(dead_rows=0.25)),
}


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_sort_live_slots_plain_is_the_whole_sort(name):
    """K13's plain version is the first num_valid entries of the stable sort
    of all P K keys (numpy's stable argsort of the uint32 keys too), with
    int32 keys, slot ids and count; K9's plain version gives the same
    outputs on it and on the whole sort at the live count, at a budget cut
    (half the live entries) and past the live count (the short list read as
    dead there)."""
    P, K, kw = SORT_CASES[name]
    keys = live_keys(P, K, "cpu", seed=len(name), **kw)
    sk, ss, count = ttiles.sort_live_slots_plain(keys)
    whole_k, whole_s = torch.sort(keys, stable=True)
    nv = int((keys != ttiles.DEAD_KEY).sum())
    assert sk.dtype == ss.dtype == count.dtype == torch.int32 and int(count) == nv
    assert sk.shape == ss.shape == (nv,)
    assert torch.equal(sk, whole_k[:nv]) and torch.equal(ss.long(), whole_s[:nv])
    assert bool((whole_k[nv:] == ttiles.DEAD_KEY).all())
    np.testing.assert_array_equal(
        n(ss), np.argsort(n(ttiles.keys_from_int32(keys)), kind="stable")[:nv])
    for m in sorted({nv, nv // 2, min(nv + 300, P * K)} - {0}):
        mp = -(-m // 256) * 256
        got = ttiles.bin_ranges_plain(sk, ss, m, mp, P, 1280, 21)
        want = ttiles.bin_ranges_plain(whole_k, whole_s.to(torch.int32), m, mp, P, 1280, 21)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), m
    expect = {"all_dead": nv == 0, "all_live": nv == P * K, "one_slot": nv == 1,
              "odd_size": (P * K) % 4 and 0 < nv < P * K,
              "ties": torch.unique(sk).numel() * 100 < nv,
              "interleaved": 0.4 < nv / (P * K) < 0.6}
    assert expect[name]


def test_sort_live_slots_on_the_cpu_is_the_plain_version():
    """sort_live_slots on CPU tensors is its plain version and counts no
    launch; on other devices it raises."""
    keys = live_keys(1000, 16, "cpu", seed=3)
    before = dict(ttiles.LAUNCHES)
    got = ttiles.sort_live_slots(keys)
    assert all(torch.equal(a, b) for a, b in zip(got, ttiles.sort_live_slots_plain(keys)))
    assert ttiles.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ttiles.sort_live_slots(keys.to("meta"))


def test_k13_geometry_is_the_kernels():
    """ops/tiles.py's SORT_LIVE_TILES, SORT_LIVE_ZERO_WORDS and
    SORT_LIVE_BINS are csrc/sort_live.cu's kCompactTile, kSortTile,
    kCompactStatusWord and kBins, which size the wrapper's scratch."""
    import os
    import re

    from torch_port_helpers import ROOT

    with open(os.path.join(ROOT, "gaussian_lic_tpu_torch", "csrc", "sort_live.cu")) as f:
        consts = dict(re.findall(r"^constexpr int (k\w+) = (\d+);", f.read(), re.M))
    assert ttiles.SORT_LIVE_TILES == (int(consts["kCompactTile"]), int(consts["kSortTile"]))
    assert ttiles.SORT_LIVE_ZERO_WORDS == int(consts["kCompactStatusWord"])
    assert ttiles.SORT_LIVE_BINS == int(consts["kBins"])


# ---------------------------------------------------------------------------
# card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------

def on(dev, d: dict, table_views: bool = True) -> dict:
    """The scene's tensors on `dev`; with `table_views`, xy and conic are
    strided views of a (P+1, 16) table, as preprocess hands them over."""
    x = {k: torch.as_tensor(v, device=dev) for k, v in d.items()}
    if table_views:
        P = x["xy"].shape[0]
        table = torch.zeros((P + 1, 16), device=dev)
        table[:P, 0:2], table[:P, 2:5] = x["xy"], x["conic"]
        x["table"] = table
        x["xy"], x["conic"] = table[:P, 0:2], table[:P, 2:5]
    return x


def assert_keys_match(x, grid, K, bits, **kw):
    g = ttiles.TileGrid(*grid)
    before = ttiles.LAUNCHES["bin_keys"]
    got = ttiles.bin_keys(*(x[k] for k in NAMES), g, K, bits, **kw)
    want = ttiles.bin_keys_plain(*(x[k] for k in NAMES), g, K, bits, **kw)
    torch.cuda.synchronize()
    assert ttiles.LAUNCHES["bin_keys"] == before + 1
    for name, a, b in zip(("keys", "tiles_touched", "sums"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return got


def k8_modes(grid_args):
    g = ttiles.TileGrid(*grid_args)
    half = max(g.n_ty // 2, 1)
    return {"band": dict(band_ty0=0, band_n_ty=g.n_ty),
            "band_low": dict(band_ty0=g.n_ty - half, band_n_ty=half),
            "global": {}}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["band", "band_low", "global"])
@pytest.mark.parametrize("tile", TILES + [(24, 40)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_k8_tile_shapes(cuda_device, tile, mode):
    """K8 at every tile of 1024 pixels and a 24x40 tile, with the edge rows
    and a NaN mean, in a band, the lower half of the grid and globally."""
    d = scene(np.random.default_rng(tile[0]), 2001, width=200, height=150, nan_mean=True)
    grid = (200, 150, tile[1], tile[0])
    bits = ttiles.rank_bits_for(ttiles.TileGrid(*grid).num_tiles)
    keys, touched, _ = assert_keys_match(on(cuda_device, d), grid, 8, bits,
                                         **k8_modes(grid)[mode])
    assert int(touched.sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [1, 8, 16])
@pytest.mark.parametrize("P", [1, 3, 129, 2001])
def test_k8_sizes_and_inputs(cuda_device, P, K):
    """K8 at P = 1, 3, 129 and 2001 (partial blocks), with contiguous and
    table-strided means and conics, from depth and from depth keys."""
    d = scene(np.random.default_rng(P + K), P)
    grid = (256, 128, 32, 32)
    bits = ttiles.rank_bits_for(ttiles.TileGrid(*grid).num_tiles)
    for views in (True, False):
        x = on(cuda_device, d, table_views=views)
        assert_keys_match(x, grid, K, bits, band_n_ty=4)
        live = x["active"] & (x["radius"] > 0)
        # compute_slot_keys_kmajor's contract: the depth keys and a live mask as given
        dk = ttiles.depth_key(x["depth"], bits)
        y = dict(x, active=live | (x["radius"] == 0))   # live rows of radius 0 too
        assert_keys_match(y, grid, K, bits, dkey=dk)
        got = ttiles.compute_slot_keys_kmajor(x["xy"], dk, x["conic"], x["opacity"],
                                              x["radius"], live, ttiles.TileGrid(*grid), K, bits)
        want = ttiles._slot_keys_chain(x["xy"], dk, x["conic"], x["opacity"], x["radius"], live,
                                       ttiles.TileGrid(*grid), K, bits)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def listed_case(name, rng):
    """(scene, grid, K, K8 keyword arguments) of one of the listed design's
    edge cases: a block whose Gaussians are all dead, a block whose every
    Gaussian's rect holds K tiles or more, an empty band, P not a multiple
    of the 256-Gaussian block, K = 1 and K = 16 (two passes of 8 slots)."""
    grid = (256, 128, 32, 32)
    K = 16 if name == "k16" else 1 if name == "k1" else 8
    P = 1000 if name == "partial_block" else 768
    d = scene(rng, P)
    kw = dict(band_ty0=0, band_n_ty=4)
    if name == "dead_block":
        d["active"][256:512] = False
    if name in ("wide_block", "k16"):   # rects of 4 x 4 tiles (>= K at K = 8 and 16)
        d["xy"][256:512] = np.array([128.0, 64.0], np.float32)
        d["radius"][256:512] = 60.0
        d["conic"][256:512] = np.array([1e-4, 0.0, 1e-4], np.float32)
        d["opacity"][256:512] = 0.9
        d["active"][256:512] = True
    if name == "empty_band":
        kw = dict(band_ty0=2, band_n_ty=0)
    return d, grid, K, kw


LISTED_CASES = ["partial_block", "dead_block", "wide_block", "empty_band", "k1", "k16"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", LISTED_CASES)
def test_k8_listed_design_edge_blocks(cuda_device, name):
    """K8 and its listed design bit for bit with the plain version on the
    listed design's edge cases (listed_case), band and global tile ids; the
    listed design and the device-kept sums (`fold`) launched three times in
    a row."""
    d, grid, K, kw = listed_case(name, np.random.default_rng(len(name)))
    x = on(cuda_device, d)
    g = ttiles.TileGrid(*grid)
    bits = ttiles.rank_bits_for(g.num_tiles)
    args = [x[k] for k in NAMES]
    for mode in (kw, {}, kw):
        keys, touched, sums = assert_keys_match(x, grid, K, bits, **mode)
        for v in ("listed", "fold"):
            got = ttiles.bin_keys_probe(v, *args, g, K, bits, **mode)
            assert all(torch.equal(a, b) for a, b in zip(got, (keys, touched, sums))), v
    if name == "wide_block":
        assert int(sums[0]) > 0      # the wide rects lost tiles to the K-slot cap
    if name == "empty_band":
        assert int(sums[1]) == 0 and int(touched.sum()) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", [v for v in ttiles.K8_VARIANTS
                                     if v not in ttiles.K8_TIMING_ONLY])
@pytest.mark.parametrize("name", ["partial_block", "wide_block", "k16"])
def test_k8_variants_bit_for_bit(cuda_device, variant, name):
    """Every K8 variant that claims K8's outputs (rcp, the 16-byte loads, the
    sums kept on the device, the listed design) equals K8 bit for bit, with
    the table's strided views (the 16-byte path) and with contiguous means
    and conics; the device-kept sums start from zero at every launch."""
    d, grid, K, kw = listed_case(name, np.random.default_rng(7))
    bits = ttiles.rank_bits_for(ttiles.TileGrid(*grid).num_tiles)
    g = ttiles.TileGrid(*grid)
    for views in (True, False):
        x = on(cuda_device, d, table_views=views)
        args = [x[k] for k in NAMES]
        want = ttiles.bin_keys(*args, g, K, bits, **kw)
        before = ttiles.PROBE_LAUNCHES[variant]
        got = ttiles.bin_keys_probe(variant, *args, g, K, bits, **kw)
        torch.cuda.synchronize()
        assert ttiles.PROBE_LAUNCHES[variant] == before + 1
        for what, a, b in zip(("keys", "tiles_touched", "sums"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), what


def plain_binning(x, grid, K, M, align=256, **kw):
    """bin_gaussians composed of the plain versions, on x's device."""
    g = ttiles.TileGrid(*grid)
    n_ty = kw.get("band_n_ty") or g.n_ty
    bits = kw.pop("depth_bits", None) or ttiles.rank_bits_for(n_ty * g.n_tx)
    keys, touched, sums = ttiles.bin_keys_plain(*(x[k] for k in NAMES), g, K, bits,
                                                band_ty0=kw.get("band_ty0", 0), band_n_ty=n_ty)
    return binning_of(keys, touched, sums, K, M, n_ty * g.n_tx, bits, align)


def binning_of(keys, touched, sums, K, M, T, bits, align=256):
    """The Binning of K8's outputs by the stable sort of all P K keys (int32
    slot ids) and K9's plain version, on the tensors' device."""
    sk, order = torch.sort(keys, stable=True)
    P = touched.shape[0]
    m_eff = min(M, P * K)
    ranges = ttiles.bin_ranges_plain(sk, order.to(torch.int32), m_eff,
                                     -(-m_eff // align) * align, P, T, bits)
    lost = torch.clamp_min(sums[1] - M, 0)
    return ttiles.Binning(*ranges, num_valid=sums[1], overflow=sums[0] + lost,
                          budget_lost=lost, truncated=sums[0], tiles_touched=touched)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(CASES) + ["band_2_of_4", "band_3_of_4"])
def test_k9_k10_on_k8_lists(cuda_device, name):
    """bin_gaussians on the card (K8, K13, K9) is the plain composition on
    the card field for field, and K10 gathers the plain rows, bit for bit;
    one launch of each."""
    band = {}
    if name.startswith("band"):
        b = int(name.split("_")[1])
        d, grid, K, M = case_inputs("random_k8", seed=b)
        band = dict(band_ty0=b, band_n_ty=1, depth_bits=ttiles.rank_bits_for(32))
    else:
        d, grid, K, M = case_inputs(name)
    x = on(cuda_device, d)
    before = dict(ttiles.LAUNCHES)
    got = ttiles.bin_gaussians(*(x[k] for k in NAMES), ttiles.TileGrid(*grid),
                               max_tiles_per_gaussian=K, max_total_splats=M, **band)
    splats = ttiles.gather_splats(x["table"], got.sorted_gauss)
    torch.cuda.synchronize()
    assert {k: ttiles.LAUNCHES[k] - before[k] for k in before} == {
        "bin_keys": 1, "sort_live": 1, "bin_ranges": 1, "gather_splats": 1}
    assert_binning_equal(got, plain_binning(x, grid, K, M, **band))
    assert torch.equal(splats, ttiles.gather_splats_plain(x["table"], got.sorted_gauss))
    assert torch.equal(splats, x["table"].index_select(0, got.sorted_gauss))


@pytest.mark.requires_cuda
def test_k10_edge_ids(cuda_device):
    """K10 with the dead id everywhere, one row, and an id past the table
    (jnp.take's fill: NaN rows)."""
    table = torch.randn(5, 16, device=cuda_device)
    ids = torch.tensor([4, 0, 3, 4, 4, 1], dtype=torch.int32, device=cuda_device)
    assert torch.equal(ttiles.gather_splats(table, ids), table[ids.long()])
    bad = ttiles.gather_splats(table, torch.tensor([5, -1, 2], dtype=torch.int32,
                                                   device=cuda_device))
    assert bool(bad[:2].isnan().all()) and torch.equal(bad[2], table[2])
    assert ttiles.gather_splats(table, ids[:0]).shape == (0, 16)


@pytest.mark.requires_cuda
def test_binning_and_gather_in_a_cuda_graph(cuda_device):
    """bin_gaussians and the gather captured in one CUDA graph and replayed
    on a second scene copied into the captured inputs equal the eager
    kernels on that scene: another live count (K13's length, read on the
    device), with the budget between the two scenes' counts, so one of the
    two lists is cut; then replayed on the first scene again."""
    grid, K = (256, 128, 32, 32), 8
    g = ttiles.TileGrid(*grid)
    x = on(cuda_device, scene(np.random.default_rng(1), 1000))
    y = on(cuda_device, scene(np.random.default_rng(2), 1000))
    x0 = {k: v.clone() for k, v in x.items()}
    counts = [int(ttiles.bin_keys(*(s[k] for k in NAMES), g, K,
                                  ttiles.rank_bits_for(g.num_tiles))[2][1]) for s in (x, y)]
    assert counts[0] != counts[1]
    M = sum(counts) // 2

    def run(s):
        b = ttiles.bin_gaussians(*(s[k] for k in NAMES), g, max_tiles_per_gaussian=K,
                                 max_total_splats=M)
        return b, ttiles.gather_splats(s["table"], b.sorted_gauss)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        first = run(x)[0].sorted_gauss.clone()   # loads the kernels outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        b_static, splats_static = run(x)
    for k in ("table", "depth", "opacity", "radius", "active"):
        x[k].copy_(y[k])
    graph.replay()
    torch.cuda.synchronize()
    b_eager, splats_eager = run(y)
    assert_binning_equal(b_static, b_eager)
    assert torch.equal(splats_static, splats_eager)
    assert not torch.equal(first, b_eager.sorted_gauss)   # the replay binned the new scene
    assert int(b_static.num_valid) == counts[1]
    assert (int(b_static.budget_lost) > 0) == (counts[1] > M)
    for k in ("table", "depth", "opacity", "radius", "active"):
        x[k].copy_(x0[k])
    graph.replay()
    torch.cuda.synchronize()
    b_eager, splats_eager = run(x)
    assert_binning_equal(b_static, b_eager)
    assert torch.equal(splats_static, splats_eager)
    assert int(b_static.num_valid) == counts[0]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(CELL_SORT_CASES) + list(SORT_CASES))
def test_k13_is_its_plain_version(cuda_device, name):
    """K13 on the card equals sort_live_slots_plain bit for bit (the first
    count entries of its K*P-long lists, and the count on the device), at
    both benchmark cells' shapes and the CPU cases, twice in a row (fresh
    scratch each call); one launch counted a call. At the cells' shapes
    about 5-8% of the slots are live."""
    P, K, kw = {**CELL_SORT_CASES, **SORT_CASES}[name]
    keys = live_keys(P, K, cuda_device, seed=len(name), **kw)
    want_k, want_s, want_n = ttiles.sort_live_slots_plain(keys)
    nv = int(want_n)
    for _ in range(2):
        before = ttiles.LAUNCHES["sort_live"]
        sk, ss, count = ttiles.sort_live_slots(keys)
        torch.cuda.synchronize()
        assert ttiles.LAUNCHES["sort_live"] == before + 1
        assert sk.shape == ss.shape == (P * K,) and count.shape == ()
        assert sk.dtype == ss.dtype == count.dtype == torch.int32
        assert int(count) == nv
        assert torch.equal(sk[:nv], want_k) and torch.equal(ss[:nv], want_s)
    if name in CELL_SORT_CASES:
        assert 0.04 < nv / (P * K) < 0.08


@pytest.mark.requires_cuda
def test_k13_graph_replays_at_other_live_counts(cuda_device):
    """K13 captured in a CUDA graph on one list of keys and replayed on
    others copied into the captured input (fewer live slots, more, none,
    all): each replay equals the plain version on those keys, the count
    included; the launch is the same at every replay."""
    P, K = 20000, 16
    lists = [live_keys(P, K, cuda_device, seed=1),
             live_keys(P, K, cuda_device, seed=2, dead_rows=0.6),
             live_keys(P, K, cuda_device, seed=3, interleaved=True),
             live_keys(P, K, cuda_device, seed=4, all_dead=True),
             live_keys(P, K, cuda_device, seed=5, all_live=True)]
    keys = lists[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ttiles.sort_live_slots(keys)   # loads the kernels outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sk, ss, count = ttiles.sort_live_slots(keys)
    seen = set()
    for new in lists[1:] + lists[:1]:
        keys.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want_k, want_s, want_n = ttiles.sort_live_slots_plain(new)
        nv = int(want_n)
        seen.add(nv)
        assert int(count) == nv
        assert torch.equal(sk[:nv], want_k) and torch.equal(ss[:nv], want_s)
    assert len(seen) == len(lists) and 0 in seen and P * K in seen


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(CASES))
def test_bin_gaussians_on_the_card_is_the_whole_sort(cuda_device, name, monkeypatch):
    """bin_gaussians on the card (K8, K13, K9) with torch.sort made to raise
    equals, field for field, the stable sort of all P K keys (int32 slot
    ids) and K9's plain version run on the CPU on the card's K8 outputs:
    with and without a budget cut, m_eff == P K, and empty tiles."""
    d, grid, K, M = case_inputs(name)
    x = on(cuda_device, d)
    g = ttiles.TileGrid(*grid)
    bits = ttiles.rank_bits_for(g.num_tiles)
    k8 = ttiles.bin_keys(*(x[k] for k in NAMES), g, K, bits, band_n_ty=g.n_ty)

    def no_sort(*args, **kwargs):
        raise AssertionError("torch.sort on the card's binning path")

    monkeypatch.setattr(torch, "sort", no_sort)
    got = ttiles.bin_gaussians(*(x[k] for k in NAMES), g, max_tiles_per_gaussian=K,
                               max_total_splats=M)
    torch.cuda.synchronize()
    monkeypatch.undo()
    want = binning_of(*(a.cpu() for a in k8), K, M, g.num_tiles, bits)
    assert_binning_equal(got, want)
    assert (int(want.budget_lost) > 0) == name.startswith("overflow")


@pytest.mark.requires_cuda
def test_train_step_sorts_the_live_slots(cuda_device, monkeypatch):
    """A train step on the card, eagerly and as a 2-step bundle (a CUDA
    graph), runs one K13 a K8 (LAUNCHES["sort_live"] == LAUNCHES["bin_keys"])
    and no torch.sort (made to raise)."""
    from gaussian_lic_tpu_torch.config import Params
    from gaussian_lic_tpu_torch.engine import trainer
    from gaussian_lic_tpu_torch.utils.synthetic import make_bench_state

    cfg = Params(width=64, height=64, fx=40.0, fy=40.0, cx=32.0, cy=32.0,
                 skybox_points_num=0, initial_capacity=2048, max_tiles_per_gaussian=16)
    intr, gm, kf, opt = make_bench_state(cfg, 2000, cuda_device)

    def no_sort(*args, **kwargs):
        raise AssertionError("torch.sort in the train step")

    monkeypatch.setattr(torch, "sort", no_sort)
    ttiles.reset_launches()
    gm, opt, _ = trainer.train_step(gm, opt, kf, 0, 1, intr=intr, cfg=cfg)
    torch.cuda.synchronize()
    assert ttiles.LAUNCHES["sort_live"] == ttiles.LAUNCHES["bin_keys"] == 1
    bundle = trainer._make_train_bundle(intr, cfg, 2, trainer.BundleGraphs())
    ttiles.reset_launches()
    bundle(gm, opt, kf, torch.tensor([1, 0], device=cuda_device), 2)
    torch.cuda.synchronize()
    assert ttiles.LAUNCHES["sort_live"] == ttiles.LAUNCHES["bin_keys"] == 2


def k9_lists(dev, name):
    """K8's outputs on the card for case `name` and the stable sort of its
    keys: (keys, touched, sums, sorted keys, int32 slot ids, P, T, bits, M)."""
    d, grid, K, M = case_inputs(name)
    g = ttiles.TileGrid(*grid)
    bits = ttiles.rank_bits_for(g.num_tiles)
    x = on(dev, d)
    keys, touched, sums = ttiles.bin_keys(*(x[k] for k in NAMES), g, K, bits, band_n_ty=g.n_ty)
    sk, ss = torch.sort(keys, stable=True)
    return keys, touched, sums, sk, ss.to(torch.int32), x["xy"].shape[0], g.num_tiles, bits, M


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", [v for v in ttiles.K9_VARIANTS
                                     if v not in ttiles.K9_TIMING_ONLY])
@pytest.mark.parametrize("name", list(CASES))
def test_k9_variants_bit_for_bit(cuda_device, variant, name):
    """Every K9 variant that claims K9's outputs equals bin_ranges_plain on
    the card, all four outputs, at the budget (m_eff) and at a cut (half the
    live entries), with K8's keys, touched and sums and without them (the
    histogram); one launch each."""
    keys, touched, sums, sk, ss, P, T, bits, M = k9_lists(cuda_device, name)
    for m in (min(M, P * keys.shape[0] // P), max(int(sums[1]) // 2, 1)):
        mp = -(-m // 256) * 256
        want = ttiles.bin_ranges_plain(sk, ss, m, mp, P, T, bits)
        for kw in ({}, dict(slot_keys=keys, touched=touched, sums=sums)):
            before = ttiles.K9_PROBE_LAUNCHES[variant]
            got = ttiles.bin_ranges_probe(variant, sk, ss, m, mp, P, T, bits, **kw)
            torch.cuda.synchronize()
            assert ttiles.K9_PROBE_LAUNCHES[variant] == before + 1
            for what, a, b in zip(("sorted_gauss", "tile_starts", "tile_lens", "cnt"), got, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (what, m, bool(kw))


@pytest.mark.requires_cuda
def test_k9_takes_k8_outputs_together(cuda_device):
    """K9 takes K8's keys, touched and sums all or none."""
    keys, touched, sums, sk, ss, P, T, bits, M = k9_lists(cuda_device, "random_k8")
    m = min(M, keys.shape[0])
    with pytest.raises(ValueError, match="together"):
        ttiles.bin_ranges(sk, ss, m, m, P, T, bits, touched=touched, sums=sums)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["random_k8", "overflow_k16"])
def test_k9_graph_replays(cuda_device, name):
    """K9 with K8's outputs, captured in a CUDA graph and replayed twice,
    gives the eager kernel's four outputs both times: the count of touched
    where the budget cuts nothing, the survivor compare where it does."""
    keys, touched, sums, sk, ss, P, T, bits, M = k9_lists(cuda_device, name)
    m_eff = min(M, keys.shape[0])
    m_pad = -(-m_eff // 256) * 256
    kw = dict(slot_keys=keys, touched=touched, sums=sums)
    eager = [a.clone() for a in ttiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **kw)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ttiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ttiles.bin_ranges(sk, ss, m_eff, m_pad, P, T, bits, **kw)
    for _ in range(2):
        for a in out:
            a.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert (int(sums[1]) > m_eff) == name.startswith("overflow")
