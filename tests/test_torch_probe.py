"""Port parity: the blend probes K3/K4 (ops/blend_probe.py).

The JAX probes (tools/probe_kernel.py, tools/probe_bwd.py) cannot run on the
CPU: they use TPU DMA semaphores and SMEM scratch, and build a 1M-Gaussian
state inside main(). So each plain variant is held, on the golden splat list
(tests/torch_goldens/blend.npz), against what it stands for:

(a) the variants that keep K1/K2's numerics (base, nocull, batch256, direct;
    base, sbuf, smematomic, nocull) against the Pallas goldens, at the
    tolerances of tests/test_torch_blend.py: image and final_T atol 1e-5,
    n_contrib exact; the per-Gaussian grads against the goldens' per-entry
    grads summed per Gaussian over seeded ids, 1e-4 relative to the max;
    `noatomic` summed over its bands against the goldens' per-entry grads,
    1e-4 relative; forward and backward nocull are also their base's plain
    version exactly;
(b) noexp, noattr, noblend and nored against a jax.numpy transcription of the
    probes' per-entry bodies (probe_kernel.py:168-196, probe_bwd.py:188-258)
    walked over each tile's in-range entries. noexp and noattr: image and
    final_T atol 1e-5 and n_contrib exact outside termination ties (pixels
    the port's plain version decides differently with 1e-4 moved by 1 ulp);
    noblend (sums of ~70 powers of up to ~1e3) 1e-5 relative to the max;
    nored (sums over NORED_PIXELS, per Gaussian) 1e-4 relative to the max.
    The transcription with the production reduction reproduces the Pallas
    goldens first, at (a)'s tolerances;
(c) the culls the kernels run: each variant's box rule keeps every pair its
    own arithmetic applies (K1's rule at K1's warp blocks for K3 base,
    batch256 and direct and every K4 variant but nocull; noexp's linear rule;
    the box of noattr's splat); nored's pixels and noatomic's bands lie in
    K2's warp blocks;
(d) `walked` at K1's batch of 128 (256 for batch256) and K2's walk;
(e) dispatch: CPU tensors take the plain version and count no launch;
    unknown variants and bad ids raise;
(f) every kernel variant against its plain version, on the card only.
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, load_golden, n, rel_max, t

from gaussian_lic_tpu_torch.ops import blend
from gaussian_lic_tpu_torch.ops import blend_probe as bp

IMG_ATOL = 1e-5
GRAD_RTOL = 1e-4
NOBLEND_RTOL = 1e-5
NORED_RTOL = 1e-4
N_GAUSS = 300     # ids of the synthetic sorted_gauss
K1_NUMERICS = ("base", "nocull", "batch256", "direct")    # K3 variants computing K1's outputs
K2_NUMERICS = ("base", "sbuf", "smematomic", "nocull")    # K4 variants computing K2's grads


@pytest.fixture(scope="module")
def golden():
    return load_golden("blend", "file")


def golden_args(d, device="cpu"):
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])
    args = (t(d["splats"]).to(device), t(d["tile_starts"]).to(device),
            t(d["tile_lens"]).to(device))
    return args, dict(n_tx=n_tx, n_ty=n_ty, tile_h=th, tile_w=tw)


def pixel_args(d, device="cpu"):
    return tuple(t(d[k]).to(device) for k in ("dl_dcolor", "final_t", "n_contrib"))


def sorted_gauss(d):
    """A seeded entry -> Gaussian map; all-zero rows (the list's padding)
    take the dead id N_GAUSS."""
    ids = np.random.default_rng(0).integers(0, N_GAUSS, len(d["splats"])).astype(np.int32)
    ids[~d["splats"].any(1)] = N_GAUSS
    return ids


def bwd_args(d, device="cpu"):
    """probe_backward's positional arguments and grid on the golden."""
    args, kw = golden_args(d, device)
    return args + pixel_args(d, device) + (t(sorted_gauss(d)).to(device),), \
        dict(kw, n_gauss=N_GAUSS)


def per_gaussian(entry_grads, ids):
    out = np.zeros((N_GAUSS + 1, entry_grads.shape[1]), np.float64)
    np.add.at(out, ids, entry_grads)
    return out[:N_GAUSS]


def tie_pixels(variant, args, kw):
    eps32 = np.float32(blend.T_EPS)
    outs = [bp.probe_forward_plain(variant, *args, t_eps=float(np.nextafter(eps32, to)),
                                   **kw) for to in (np.float32(0), np.float32(1))]
    return n((outs[0][2] != outs[1][2]) | (outs[0][1] != outs[1][1]))


# ------------------------------------------------------- JAX transcriptions

def _tiles(d, variant=None):
    """(T, L, 9) in-range attributes of each tile (noattr: the constant
    splat), (T, L) validity, (T, 1024) pixel x and y."""
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])
    starts, lens = d["tile_starts"], d["tile_lens"]
    L = int(lens.max())
    rows = np.zeros((len(lens), L, 9), np.float32)
    valid = np.arange(L)[None, :] < lens[:, None]
    for i, (s, ln) in enumerate(zip(starts, lens)):
        rows[i, :ln] = bp.NOATTR_SPLAT if variant == "noattr" else d["splats"][s:s + ln, :9]
    flat = np.arange(th * tw)
    tiles = np.arange(len(lens))
    px = ((tiles % n_tx)[:, None] * tw + flat[None] % tw).astype(np.float32)
    py = ((tiles // n_tx)[:, None] * th + flat[None] // tw).astype(np.float32)
    return rows, valid, px, py


def _to_image(x, d):
    """(T, ..., 1024) -> (..., H, W)."""
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])
    x = np.asarray(x)
    lead = x.shape[1:-1]
    x = x.reshape((n_ty, n_tx) + lead + (th, tw))
    x = np.moveaxis(x, (0, 1), (len(lead), len(lead) + 2))
    return x.reshape(lead + (n_ty * th, n_tx * tw))


def jax_forward_probe(d, variant):
    """probe_kernel.py's per-entry body (:168-196) as a lax.scan over each
    tile's entries; out-of-range entries get opacity 0 as there, and noblend's
    power is taken over in-range entries only (the TPU walks whole chunks)."""
    import jax
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD
    from gaussian_lic_tpu.ops.rasterize_ref import ALPHA_CAP, T_EPS

    rows, valid, px, py = _tiles(d, variant)

    def walk(rows_t, valid_t, px, py):
        def body(carry, inp):
            T, Cr, Cg, Cb, done, last = carry
            (x, y, A, B, Cc, opa, r, g, b), ok, pos = inp
            opa = jnp.where(ok, opa, 0.0)
            nA = -0.5 * A
            nC = -0.5 * Cc
            dx = x - px
            dy = y - py
            power = (nA * dx - B * dy) * dx + (nC * dy) * dy
            if variant == "noblend":
                power = jnp.where(ok, power, 0.0)
                return (T, Cr + power, Cg + power * 0.5, Cb + power * 0.25, done, last), None
            G = power * 0.1 + 0.9 if variant == "noexp" else jnp.exp(power)
            alpha = jnp.minimum(ALPHA_CAP, opa * G)
            contrib = (alpha >= OPACITY_THRESHOLD) & (power <= 0.0)
            test_T = T * (1.0 - alpha)
            would_term = contrib & (test_T < T_EPS)
            applied = contrib & (done < 0.5) & jnp.logical_not(would_term)
            done = jnp.maximum(done, would_term.astype(jnp.float32))
            w = jnp.where(applied, alpha, 0.0) * T
            last = jnp.where(applied, pos, last)
            T = jnp.where(applied, test_T, T)
            return (T, Cr + w * r, Cg + w * g, Cb + w * b, done, last), None

        z = jnp.zeros_like(px)
        init = (jnp.ones_like(px), z, z, z, z, jnp.zeros(px.shape, jnp.int32))
        pos = jnp.arange(1, rows_t.shape[0] + 1, dtype=jnp.int32)
        (T, Cr, Cg, Cb, _, last), _ = jax.lax.scan(
            body, init, (tuple(rows_t[:, i] for i in range(9)), valid_t, pos))
        return jnp.stack([Cr, Cg, Cb]), T, last

    color, T, last = jax.jit(jax.vmap(walk))(rows, valid, px, py)
    return _to_image(color, d), _to_image(T, d), _to_image(last, d)


def jax_backward_probe(d, pixels=None):
    """probe_bwd.py's per-entry body (:188-258) as a reverse lax.scan over
    each tile's entries; `pixels` (flat indices) replaces the full reduction
    as nored's row slice replaces it there. Returns (M_pad, 9)."""
    import jax
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD
    from gaussian_lic_tpu.ops.rasterize_ref import ALPHA_CAP

    rows, valid, px, py = _tiles(d)
    n_tx, n_ty, th, tw = (int(v) for v in d["grid"])

    def to_tiles(img):
        x = np.asarray(img).reshape(img.shape[:-2] + (n_ty, th, n_tx, tw))
        x = np.moveaxis(x, (-4, -2), (0, 1))
        return x.reshape((n_ty * n_tx,) + img.shape[:-2] + (th * tw,))

    dl = to_tiles(d["dl_dcolor"])                           # (T, 3, 1024)
    ft, nc = to_tiles(d["final_t"]), to_tiles(d["n_contrib"])
    sel = np.arange(th * tw) if pixels is None else np.asarray(pixels)

    def walk(rows_t, valid_t, px, py, dl, ft, nc):
        dlr, dlg, dlb = dl

        def body(carry, inp):
            T_run, Sdl = carry
            (x, y, A, B, Cc, opa, rr, gg, bb), ok, pos = inp
            opa = jnp.where(ok, opa, 0.0)
            nA = -0.5 * A
            nC = -0.5 * Cc
            dx = x - px
            dy = y - py
            power = (nA * dx - B * dy) * dx + (nC * dy) * dy
            G = jnp.exp(power)
            alpha = jnp.minimum(ALPHA_CAP, opa * G)
            applied = (alpha >= OPACITY_THRESHOLD) & (power <= 0.0) & (pos <= nc)
            inv_om = 1.0 / (1.0 - alpha)
            T_run = jnp.where(applied, T_run * inv_om, T_run)
            w = alpha * T_run
            s1 = rr * dlr + gg * dlg + bb * dlb
            dalpha = jnp.where(applied, T_run * s1 - Sdl * inv_om, 0.0)
            wsel = jnp.where(applied, w, 0.0)
            E = G * dalpha
            gd = opa * E
            t1 = gd * dx
            t2 = gd * dy

            def rsum(q):
                return jnp.sum(q[sel])

            m1, m2 = rsum(t1), rsum(t2)
            rec = jnp.stack([-(A * m1 + B * m2), -(Cc * m2 + B * m1), -0.5 * rsum(t1 * dx),
                             -rsum(t1 * dy), -0.5 * rsum(t2 * dy), rsum(E),
                             rsum(wsel * dlr), rsum(wsel * dlg), rsum(wsel * dlb)])
            return (T_run, Sdl + wsel * s1), rec

        pos = jnp.arange(1, rows_t.shape[0] + 1, dtype=jnp.int32)
        _, recs = jax.lax.scan(body, (ft, jnp.zeros_like(ft)),
                               (tuple(rows_t[:, i] for i in range(9)), valid_t, pos),
                               reverse=True)
        return recs

    recs = np.asarray(jax.jit(jax.vmap(walk))(rows, valid, px, py, dl, ft, nc))
    out = np.zeros((len(d["splats"]), 9), np.float32)
    for i, (s, ln) in enumerate(zip(d["tile_starts"], d["tile_lens"])):
        out[s:s + ln] = recs[i, :ln]
    return out


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("variant", K1_NUMERICS)
def test_forward_k1_numerics_vs_pallas(golden, variant):
    args, kw = golden_args(golden)
    color, final_t, n_contrib = bp.probe_forward_plain(variant, *args, **kw)
    np.testing.assert_allclose(n(color), golden["color"], atol=IMG_ATOL, rtol=0)
    np.testing.assert_allclose(n(final_t), golden["final_t"], atol=IMG_ATOL, rtol=0)
    np.testing.assert_array_equal(n(n_contrib), golden["n_contrib"])


@pytest.mark.parametrize("variant", K2_NUMERICS)
def test_backward_k2_numerics_vs_pallas(golden, variant):
    """The per-Gaussian grads against the Pallas per-entry grads summed per
    Gaussian over the same ids."""
    args, kw = bwd_args(golden)
    grads = bp.probe_backward_plain(variant, *args, **kw)
    ref = per_gaussian(golden["entry_grads"], sorted_gauss(golden))
    assert grads.shape == (N_GAUSS, blend.N_ATTR) and np.abs(ref).max() > 0
    assert rel_max(n(grads), ref) < GRAD_RTOL


def test_noatomic_vs_pallas_summed_over_bands(golden):
    """noatomic's band records, summed over the bands, against the Pallas
    per-entry grads; each band's record is not the whole."""
    args, kw = bwd_args(golden)
    grads = n(bp.probe_backward_plain("noatomic", *args, **kw))
    assert grads.shape == (bp.BWD_BANDS, len(golden["splats"]), blend.N_ATTR)
    assert rel_max(grads.sum(0), golden["entry_grads"]) < GRAD_RTOL
    assert all(rel_max(g, golden["entry_grads"]) > 1e-2 for g in grads)


@pytest.mark.parametrize("direction,variant,base", [("forward", "nocull", "base"),
                                                    ("backward", "nocull", "base")])
def test_cull_variants_are_base(golden, direction, variant, base):
    """K3 nocull's function is K1's and K4 nocull's is K2's: their plain
    versions are base's, bit for bit (the kernels differ from base only in
    the pairs base skips, which apply nowhere; on the card K4 nocull sums in
    another order)."""
    if direction == "forward":
        args, kw = golden_args(golden)
        for a, b in zip(bp.probe_forward_plain(variant, *args, **kw),
                        bp.probe_forward_plain(base, *args, **kw)):
            assert torch.equal(a, b)
    else:
        args, kw = bwd_args(golden)
        assert torch.equal(bp.probe_backward_plain(variant, *args, **kw),
                           bp.probe_backward_plain(base, *args, **kw))


# --------------------------------------------------------------------- (b)

def test_forward_transcription_reproduces_pallas(golden):
    color, final_t, n_contrib = jax_forward_probe(golden, "base")
    np.testing.assert_allclose(color, golden["color"], atol=IMG_ATOL, rtol=0)
    np.testing.assert_allclose(final_t, golden["final_t"], atol=IMG_ATOL, rtol=0)
    np.testing.assert_array_equal(n_contrib, golden["n_contrib"])


def test_backward_transcription_reproduces_pallas(golden):
    assert rel_max(jax_backward_probe(golden), golden["entry_grads"]) < GRAD_RTOL


@pytest.mark.parametrize("variant", ["noexp", "noattr"])
def test_forward_substitution_vs_jax(golden, variant):
    args, kw = golden_args(golden)
    color, final_t, n_contrib = (n(x) for x in bp.probe_forward_plain(variant, *args, **kw))
    ref = jax_forward_probe(golden, variant)
    base = n(bp.probe_forward_plain("base", *args, **kw)[0])
    assert np.abs(ref[0] - base).max() > 1e-2, "the substitution changed nothing"
    ok = ~tie_pixels(variant, args, kw)
    np.testing.assert_array_equal(n_contrib[ok], ref[2][ok])
    np.testing.assert_allclose(color[:, ok], ref[0][:, ok], atol=IMG_ATOL, rtol=0)
    np.testing.assert_allclose(final_t[ok], ref[1][ok], atol=IMG_ATOL, rtol=0)


def test_noblend_vs_jax(golden):
    args, kw = golden_args(golden)
    color, final_t, n_contrib = (n(x) for x in bp.probe_forward_plain("noblend", *args, **kw))
    ref = jax_forward_probe(golden, "noblend")[0]
    assert rel_max(color, ref) < NOBLEND_RTOL
    assert (final_t == 1.0).all() and (n_contrib == 0).all()


def test_nored_vs_jax(golden):
    """nored per Gaussian: the transcription's per-entry records over
    NORED_PIXELS, summed per Gaussian over the same ids."""
    args, kw = bwd_args(golden)
    grads = n(bp.probe_backward_plain("nored", *args, **kw))
    ids = sorted_gauss(golden)
    ref = per_gaussian(jax_backward_probe(golden, pixels=bp.NORED_PIXELS), ids)
    assert np.abs(ref).max() > 0, "no record from the first lanes' pixels"
    assert rel_max(grads, ref) < NORED_RTOL
    full = per_gaussian(golden["entry_grads"], ids)
    assert rel_max(grads, full) > 1e-2   # it is not the full reduction


# --------------------------------------------------------------------- (c)

def contrib_outside_keep(splats, starts, lens, kw, exp=torch.exp, linear=False):
    """The (entry, pixel) pairs that `exp`'s arithmetic applies in a warp
    block that the cull (`linear`: noexp's rule) skips."""
    keep = blend.warp_cull_keep(splats, starts, lens, linear=linear, **kw)
    blocks = blend._pixel_blocks(kw["tile_h"], kw["tile_w"], splats.device)
    bad = 0
    for tiles, L in blend._tile_chunks(lens):
        e, _, valid = blend._gather_entries(splats, starts, lens, tiles, L)
        px, py = blend._pixel_coords(tiles, kw["n_tx"], kw["tile_h"], kw["tile_w"])
        contrib = blend._alpha(e, px, py, exp)[5] & valid[..., None]
        bad += int((contrib & ~keep[tiles, :L][:, :, blocks]).sum())
    return keep, bad


def wide_rows():
    """Splats at the edges of noexp's linear rule: opacities from just above
    its 'applies nowhere' bound (0.9 opa = 1/255) up, wide and narrow conics,
    spread over a 64x64 image; each listed in all 4 tiles."""
    rng = np.random.default_rng(3)
    m = 200
    thr = np.float32(1.0 / 255.0)
    opa = np.concatenate([thr / np.float32(0.9) * np.float32(1.0001) * np.ones(20),
                          rng.uniform(0.005, 0.05, 80), rng.uniform(0.05, 1.0, 100)])
    rows = np.zeros((m, blend.SPLAT_ROWS), np.float32)
    rows[:, 0:2] = rng.uniform(-4, 68, (m, 2))
    s = rng.uniform(0.3, 8.0, (m, 2))
    rows[:, 2], rows[:, 3], rows[:, 4] = 1 / s[:, 0] ** 2, rng.uniform(-0.02, 0.02, m), \
        1 / s[:, 1] ** 2
    rows[:, 5] = opa
    rows[:, 6:9] = 0.5
    args = (t(rows), torch.zeros(4, dtype=torch.int32), torch.full((4,), m, dtype=torch.int32))
    return args, dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)


@pytest.mark.parametrize("rule", ["base", "noexp", "noattr"])
@pytest.mark.parametrize("scene", ["golden", "wide"])
def test_variant_cull_keeps_every_applied_pair(golden, rule, scene):
    """Each cull skips only pairs its variant's arithmetic does not apply,
    so the kernel walking the kept pairs computes its plain version, and it
    does skip some."""
    args, kw = golden_args(golden) if scene == "golden" else wide_rows()
    if rule == "noattr":
        args = (bp.noattr_list(args[0]),) + args[1:]
    keep, bad = contrib_outside_keep(*args, kw, exp=bp._noexp if rule == "noexp" else torch.exp,
                                     linear=rule == "noexp")
    assert bad == 0
    assert 0.0 < float(keep.sum()) / (int(args[2].sum()) * keep.shape[2]) < 1.0


def test_noexp_box_holds_more_than_k1s(golden):
    """The linear G passes far below K1's threshold (power ~ -9, not
    ~ -ln(255 opa)): K1's box would skip pairs noexp applies."""
    args, kw = golden_args(golden)
    _, bad = contrib_outside_keep(*args, kw, exp=bp._noexp, linear=False)
    assert bad > 0


# --------------------------------------------------------------------- (d)

@pytest.mark.parametrize("variant", bp.FORWARD_VARIANTS)
def test_forward_walked(golden, variant):
    """Entries walked per tile: a range that one batch holds is walked whole."""
    args, kw = golden_args(golden)
    walked = torch.full((len(golden["tile_lens"]),), -1, dtype=torch.int32)
    bp.probe_forward_plain(variant, *args, walked=walked, **kw)
    assert golden["tile_lens"].max() <= 128   # one batch holds each range
    np.testing.assert_array_equal(n(walked), golden["tile_lens"])


@pytest.mark.parametrize("variant", bp.BACKWARD_VARIANTS)
def test_backward_walked(golden, variant):
    """K2's walk: every variant starts at min(max n_contrib, len)."""
    args, kw = bwd_args(golden)
    walked = torch.zeros(len(golden["tile_lens"]), dtype=torch.int32)
    bp.probe_backward_plain(variant, *args, walked=walked, **kw)
    nmax = blend._to_tiles(t(golden["n_contrib"]), **golden_args(golden)[1]).amax(1)
    np.testing.assert_array_equal(n(walked), np.minimum(n(nmax), golden["tile_lens"]))
    assert (n(walked) < golden["tile_lens"]).any()   # the walk starts below the range end


def test_walked_stops_at_the_batch_of_the_last_stop():
    """A tile whose pixels all stop within the first 128 entries walks 128
    of its 600, and 256 with batch256."""
    L = 600
    splats = torch.zeros((L, blend.SPLAT_ROWS))
    # opacity 0.95 over the whole tile: every pixel stops at the 4th entry
    splats[:, :9] = torch.tensor([16.0, 16.0, 1e-6, 0.0, 1e-6, 0.95, 0.5, 0.5, 0.5])
    args = (splats, torch.zeros(1, dtype=torch.int32), torch.full((1,), L, dtype=torch.int32))
    kw = dict(n_tx=1, n_ty=1, tile_h=32, tile_w=32)
    for variant, expect in (("base", 128), ("nocull", 128), ("batch256", 256), ("noblend", L)):
        walked = torch.zeros(1, dtype=torch.int32)
        _, final_t, _ = bp.probe_forward_plain(variant, *args, walked=walked, **kw)
        assert int(walked) == expect, variant
    assert float(final_t.max()) == 1.0   # noblend never stops


@pytest.mark.parametrize("tile", [(1 << i, 1024 >> i) for i in range(11)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_nored_pixels_are_each_bands_first_thread(tile):
    """Band b's first thread is lane 0 of K1's warp block 2b: its 4 pixels lie
    in that block, and the band's pixels are its two blocks'."""
    th, tw = tile
    pixels = bp.nored_pixels(th, tw)
    blocks = blend._pixel_blocks(th, tw, "cpu")
    assert len(pixels) == 16 and len(set(pixels)) == 16
    for b in range(bp.BWD_BANDS):
        mine = pixels[4 * b:4 * b + 4]
        assert set(mine) <= set(bp.band_pixels(b, th, tw).tolist())
        assert all(int(blocks[p]) == 2 * b for p in mine)
        assert mine == tuple(blend.warp_block_pixels(th, tw)[2 * b, 0].tolist())
    band = torch.cat([bp.band_pixels(b, th, tw) for b in range(bp.BWD_BANDS)])
    assert sorted(band.tolist()) == list(range(blend.TILE_PIX))   # each pixel in one band
    if tile == (32, 32):   # 8x16 blocks: lane 0's pixels 4 rows apart
        assert bp.NORED_PIXELS == pixels and pixels[:5] == (0, 128, 256, 384, 16)


# --------------------------------------------------------------------- (e)

class TestDispatch:
    @pytest.mark.parametrize("variant", bp.FORWARD_VARIANTS)
    def test_forward_cpu_takes_the_plain_version(self, golden, variant):
        args, kw = golden_args(golden)
        before = dict(bp.LAUNCHES)
        out = bp.probe_forward(variant, *args, **kw)
        for a, b in zip(out, bp.probe_forward_plain(variant, *args, **kw)):
            assert torch.equal(a, b)
        assert bp.LAUNCHES == before

    @pytest.mark.parametrize("variant", bp.BACKWARD_VARIANTS)
    def test_backward_cpu_takes_the_plain_version(self, golden, variant):
        args, kw = bwd_args(golden)
        before = dict(bp.LAUNCHES)
        out = bp.probe_backward(variant, *args, **kw)
        assert torch.equal(out, bp.probe_backward_plain(variant, *args, **kw))
        assert bp.LAUNCHES == before

    def test_unknown_variants_and_missing_ids_raise(self, golden):
        args, kw = golden_args(golden)
        bargs, bkw = bwd_args(golden)
        with pytest.raises(ValueError):
            bp.probe_forward("batch512", *args, **kw)
        with pytest.raises(ValueError):
            bp.probe_backward("fused", *bargs, **bkw)
        with pytest.raises(TypeError):   # every variant takes K2's entry -> Gaussian ids
            bp.probe_backward("base", *bargs[:-1], **bkw)
        with pytest.raises(ValueError):
            bp.probe_backward("base", *bargs[:-1], bargs[-1].long(), **bkw)
        with pytest.raises(ValueError):
            bp.probe_backward("base", *bargs, **dict(bkw, n_gauss=-1))
        with pytest.raises(ValueError):
            bp.probe_backward("base", *bargs, tile_order=torch.zeros(3, dtype=torch.int32),
                              **bkw)
        with pytest.raises(ValueError):
            bp.probe_forward("base", *args, walked=torch.zeros(3, dtype=torch.int32), **kw)


# --------------------------------------------------------------------- (f)

def check_backward(variant, g, ref, skipped=None):
    """A K4 variant's grads against its plain version: per column within
    GRAD_RTOL of the column's max (nored: NORED_RTOL of the max); rows in
    `skipped` (NaN-opacity ones) must be 0 on the card and are left out."""
    g, ref = n(g).reshape(-1, blend.N_ATTR), n(ref).reshape(-1, blend.N_ATTR)
    assert np.isfinite(g).all()
    if skipped is not None:
        assert not g[skipped].any()
        g, ref = g[~skipped], ref[~skipped]
    if variant == "nored":
        assert rel_max(g, ref) < NORED_RTOL
        return
    for i in range(blend.N_ATTR):
        assert rel_max(g[:, i], ref[:, i]) < GRAD_RTOL, i


@pytest.mark.requires_cuda
class TestProbesOnTheCard:
    """Every K3/K4 variant on the card against its plain version on the same
    card, `walked` exactly; the variants that compute K1's outputs also
    against K1 bit for bit, those that compute K2's against K2 per column."""

    @pytest.mark.parametrize("variant", bp.FORWARD_VARIANTS)
    def test_forward_variant(self, golden, cuda_device, variant):
        args, kw = golden_args(golden, cuda_device)
        tiles = len(golden["tile_lens"])
        wk, wp = (torch.full((tiles,), -1, dtype=torch.int32, device=cuda_device)
                  for _ in range(2))
        before = bp.LAUNCHES[f"forward_{variant}"]
        out = [n(x) for x in bp.probe_forward(variant, *args, walked=wk, **kw)]
        ref = [n(x) for x in bp.probe_forward_plain(variant, *args, walked=wp, **kw)]
        assert bp.LAUNCHES[f"forward_{variant}"] == before + 1
        np.testing.assert_array_equal(n(wk), n(wp))
        if variant == "noblend":
            assert rel_max(out[0], ref[0]) < NOBLEND_RTOL
            np.testing.assert_array_equal(out[1], ref[1])
        else:
            np.testing.assert_allclose(out[0], ref[0], atol=IMG_ATOL, rtol=0)
            np.testing.assert_allclose(out[1], ref[1], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(out[2], ref[2])
        if variant in K1_NUMERICS:
            for a, b in zip(out, blend.blend_forward(*args, **kw)):
                np.testing.assert_array_equal(a, n(b))

    @pytest.mark.parametrize("variant", bp.BACKWARD_VARIANTS)
    def test_backward_variant(self, golden, cuda_device, variant):
        args, kw = bwd_args(golden, cuda_device)
        tiles = len(golden["tile_lens"])
        wk, wp = (torch.zeros(tiles, dtype=torch.int32, device=cuda_device) for _ in range(2))
        g = bp.probe_backward(variant, *args, walked=wk, **kw)
        ref = bp.probe_backward_plain(variant, *args, walked=wp, **kw)
        np.testing.assert_array_equal(n(wk), n(wp))
        check_backward(variant, g, ref)
        if variant in K2_NUMERICS:
            check_backward(variant, g, blend.blend_backward(*args, **kw))

    def test_backward_in_tile_order(self, golden, cuda_device):
        """base launched in tile order computes K2's grads too."""
        args, kw = bwd_args(golden, cuda_device)
        order = torch.arange(len(golden["tile_lens"]), dtype=torch.int32, device=cuda_device)
        check_backward("base", bp.probe_backward("base", *args, tile_order=order, **kw),
                       bp.probe_backward_plain("base", *args, **kw))


def nan_scene(d, device):
    """The blend golden's list with a NaN-opacity row in front of each tile
    (utils/synthetic.nan_opacity_list), K2's per-pixel inputs on it,
    and an entry -> Gaussian map that gives the NaN rows ids of their own."""
    from gaussian_lic_tpu_torch.utils.synthetic import nan_opacity_list

    sp, st, ln, nan_at = nan_opacity_list(d["splats"], d["tile_starts"], d["tile_lens"])
    args = tuple(t(a).to(device) for a in (sp, st, ln))
    kw = dict(n_tx=2, n_ty=2, tile_h=32, tile_w=32)
    _, ft, nc = blend.blend_forward_plain(*args, **kw)
    ids = np.random.default_rng(1).integers(0, N_GAUSS - 4, len(sp)).astype(np.int32)
    ids[nan_at] = np.arange(N_GAUSS - 4, N_GAUSS)
    return args, kw, (t(d["dl_dcolor"]).to(device), ft, nc), t(ids).to(device), nan_at


@pytest.mark.requires_cuda
class TestNanOpacityOnTheCard:
    """Every K3/K4 variant skips a NaN-opacity row as its plain version does
    (splat_alpha keeps the NaN, csrc/blend_common.cuh). The backward of a
    skipped row is 0 on the card and opa * 0 = NaN in the plain version, so
    the backward is held on the other rows, and the NaN rows' must be 0."""

    @pytest.mark.parametrize("variant", bp.FORWARD_VARIANTS)
    def test_forward(self, golden, cuda_device, variant):
        args, kw, _, _, _ = nan_scene(golden, cuda_device)
        out = [n(x) for x in bp.probe_forward(variant, *args, **kw)]
        ref = [n(x) for x in bp.probe_forward_plain(variant, *args, **kw)]
        assert np.isfinite(out[0]).all() and np.isfinite(out[1]).all()
        if variant == "noblend":
            assert rel_max(out[0], ref[0]) < NOBLEND_RTOL
        else:
            np.testing.assert_allclose(out[0], ref[0], atol=IMG_ATOL, rtol=0)
            np.testing.assert_allclose(out[1], ref[1], atol=IMG_ATOL, rtol=0)
        np.testing.assert_array_equal(out[2], ref[2])

    @pytest.mark.parametrize("variant", bp.BACKWARD_VARIANTS)
    def test_backward(self, golden, cuda_device, variant):
        args, kw, pix, ids, nan_at = nan_scene(golden, cuda_device)
        bargs, bkw = args + pix + (ids,), dict(kw, n_gauss=N_GAUSS)
        g = bp.probe_backward(variant, *bargs, **bkw)
        ref = bp.probe_backward_plain(variant, *bargs, **bkw)
        if variant == "noatomic":   # the NaN rows of every band
            skipped = np.zeros((bp.BWD_BANDS, len(ids)), bool)
            skipped[:, nan_at] = True
        else:                       # the NaN rows' Gaussians
            skipped = np.zeros(N_GAUSS, bool)
            skipped[N_GAUSS - 4:] = True
        check_backward(variant, g, ref, skipped.reshape(-1))


@pytest.mark.parametrize("path", ["gaussian_lic_tpu_torch/ops/blend_probe.py",
                                  "gaussian_lic_tpu_torch/utils/cuda_timing.py",
                                  "gaussian_lic_tpu_torch/utils/synthetic.py",
                                  "tools/probe_torch_kernel.py", "tools/probe_torch_bwd.py"])
def test_probe_path_imports_no_jax(path):
    import os
    import re

    from torch_port_helpers import ROOT

    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    assert not re.search(r"^\s*(import|from)\s+(jax|gaussian_lic_tpu)\b(?!_torch)", src, re.M)
