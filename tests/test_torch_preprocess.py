"""Port parity of the per-Gaussian preprocess (ops/preprocess.py): K5's plain
chain and K6's plain closed form, against the JAX package's
`project_gaussians` + `eval_sh_color` + `_pack_rows` and their autodiff.

A seeded scene of ~2k Gaussians at 64x48, SH degrees 0-3, with edge rows:
NaN opacity, behind the camera, det = 0 (a needle a million times longer
than wide), tx and ty clamped, an SH colour below 0, inactive. Tolerances:

  * forward against JAX: rows and depth within 2e-6 of each column's max,
    radius and base_active exact. Float32, the same operations, but XLA's
    CPU build contracts products and sums of the EWA conic into FMAs: the
    conic's B = -b / det, b a sum of three products that cancels, comes out
    1.2e-6 of its column's max apart (A and C 4e-7; xy, depth, opacity and
    colour equal);
  * the closed form against autograd of the plain chain in float64, and in
    float32 against jax.vjp of JAX's chain: within 1e-5 of each column's
    max. In float64 the needle's determinant is not 0 but 0.3 s (a^2 + b^2)
    beside a c ~ 1e30, which float64 resolves to no digit, so both sides'
    values of that row are rounding noise there: the float64 check leaves it
    out (the float32 ones hold it).

Each edge row is held apart from the scene, within the tolerance of its
own largest entry of the output: its values are orders of magnitude off
the scene's (the needle's scale is 1e7).
  * the Function's CPU gradient equals autograd's bit for bit (its backward
    is autograd over the plain chain's record).

The `requires_cuda` cases hold K5 and K6 against their plain versions on the
card (K5 within 1e-6 of each column's max, K6 within 1e-5). JAX is imported
inside the tests that use it, so the card tests collect without it.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import cuda_device, n  # noqa: F401 (a fixture)

from gaussian_lic_tpu_torch.camera import Camera, CameraPose, Intrinsics, look_at, make_camera
from gaussian_lic_tpu_torch.ops import preprocess as pre
from gaussian_lic_tpu_torch.ops.blend import N_ATTR

RIG = dict(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0)
P_SCENE = 2000
FWD_RTOL = 1e-6     # of each column's max: K5 against its plain version
JAX_FWD_RTOL = 2e-6  # of each column's max: the plain chain against JAX's
GRAD_RTOL = 1e-5    # of each column's max
EDGES = ("nan_opacity", "behind", "det_zero", "clamp_x", "clamp_y", "sh_negative", "inactive")
INPUTS = ("xyz", "scale", "quat", "opacity", "dc", "sh_rest")


def scene(seed=3):
    """(numpy inputs of P_SCENE Gaussians, active mask, {edge: row})."""
    rng = np.random.default_rng(seed)
    P = P_SCENE
    z = rng.uniform(2.0, 10.0, P)
    d = dict(
        xyz=np.stack([rng.uniform(-0.6, 0.6, P) * z, rng.uniform(-0.45, 0.45, P) * z, z], 1),
        scale=np.abs(rng.normal(size=(P, 3))) * 0.05 + 0.01,
        quat=rng.normal(size=(P, 4)),
        opacity=rng.uniform(0.0, 1.0, P),
        dc=rng.normal(size=(P, 3)) * 0.5,
        sh_rest=rng.normal(size=(P, 15, 3)) * 0.3,
    )
    d = {k: v.astype(np.float32) for k, v in d.items()}
    active = rng.uniform(size=P) < 0.95
    rows = dict(zip(EDGES, range(0, 2 * len(EDGES), 2)))
    d["opacity"][rows["nan_opacity"]] = np.nan
    d["xyz"][rows["behind"]] = [0.3, -0.2, -3.0]
    # a needle whose float32 EWA determinant rounds to exactly 0; its
    # quaternion's norm (2) is exact in any summation order
    r = rows["det_zero"]
    d["xyz"][r] = [-0.9180529713630676, -0.08187621086835861, 6.541126251220703]
    d["scale"][r] = [2148196.0, 1e-3, 1e-3]
    d["quat"][r] = [1.0, 1.0, 1.0, -1.0]
    d["xyz"][rows["clamp_x"]] = [25.0, 0.5, 5.0]
    d["xyz"][rows["clamp_y"]] = [0.5, -30.0, 6.0]
    d["dc"][rows["sh_negative"]] = [-5.0, 0.2, -4.0]
    d["opacity"][rows["inactive"]] = 0.8
    active[rows["inactive"]] = False
    return d, active, rows


def torch_camera(dtype=torch.float32, device="cpu"):
    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]), up=(0.0, -1.0, 0.0))
    cam = make_camera(Intrinsics(**RIG), R_wc, t_wc, device=device)
    return Camera(cam.intr, CameraPose(cam.pose.R_cw.to(dtype), cam.pose.t_cw.to(dtype)),
                  cam.full_proj.to(dtype))


def jax_camera():
    from gaussian_lic_tpu import camera as jcam

    R_wc, t_wc = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]), up=(0.0, -1.0, 0.0))
    return jcam.make_camera(jcam.Intrinsics(**RIG), R_wc, t_wc)


def jax_chain(deg, active):
    """JAX's project_gaussians + eval_sh_color + _pack_rows:
    (xyz, scale, quat, opacity, dc, sh_rest) -> (rows, depth, radius, base_active)."""
    import jax.numpy as jnp

    from gaussian_lic_tpu.ops.projection import OPACITY_THRESHOLD, project_gaussians
    from gaussian_lic_tpu.ops.rasterize import _pack_rows
    from gaussian_lic_tpu.ops.sh import eval_sh_color

    cam = jax_camera()

    def f(xyz, scale, quat, opacity, dc, sh_rest):
        proj = project_gaussians(xyz, scale, quat, cam)
        base = proj.in_front & proj.det_valid & (opacity >= OPACITY_THRESHOLD) & active
        radius = jnp.where(base, proj.radius, 0.0)
        rgb = eval_sh_color(deg, dc, sh_rest, xyz - cam.cam_center)
        return _pack_rows(proj.xy, proj.conic, opacity, rgb), proj.depth, radius, base

    return f


def check_columns(got, want, rtol, groups, what):
    """Each column of `got` within rtol of the column's max |want| over the
    scene's rows, and each edge row within rtol of its own max |want|; NaN
    where `want` is NaN."""
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    for name, rows in groups.items():
        scale = np.abs(want[rows]).max(0 if name == "scene" else None)
        err = np.abs(got[rows] - want[rows]).max(0)
        bad = err > rtol * scale
        assert not bad.any(), (f"{what} rows {name}: columns {np.where(bad)[0].tolist()} off by "
                               f"{(err / np.maximum(scale, 1e-300))[bad].tolist()} of their max")


def row_groups(rows, leave_out=()):
    normal = np.setdiff1d(np.arange(P_SCENE), list(rows.values()))
    return {"scene": normal,
            **{k: np.array([r]) for k, r in rows.items() if k not in leave_out}}


def torch_inputs(d, dtype=torch.float32, device="cpu", grad=False):
    return {k: torch.as_tensor(d[k], dtype=dtype, device=device).requires_grad_(grad)
            for k in INPUTS}


def plain_grads(x, cam, deg, active, d_attrs):
    """Autograd of the plain chain for the rows' gradient d_attrs."""
    rows = pre.preprocess_forward_plain(x["xyz"], x["scale"], x["quat"], x["opacity"], cam,
                                        x["dc"], x["sh_rest"], deg, active)["rows"]
    cot = torch.nn.functional.pad(d_attrs, (0, rows.shape[1] - N_ATTR))
    return torch.autograd.grad(rows, [x[k] for k in INPUTS], cot, allow_unused=True)


def d_attrs_for(P, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(np.random.default_rng(11).normal(size=(P, N_ATTR)), dtype=dtype,
                           device=device)


DEGREES = [0, 1, 2, 3]


def test_the_edge_rows_are_live():
    d, active, rows = scene()
    x = torch_inputs(d)
    terms = pre.projection_terms(x["xyz"], x["scale"], x["quat"], torch_camera())
    assert float(terms["det"][rows["det_zero"]]) == 0.0
    assert not bool(terms["in_front"][rows["behind"]])
    assert float(terms["cx"][rows["clamp_x"]]) != float(terms["rx"][rows["clamp_x"]])
    assert float(terms["cy"][rows["clamp_y"]]) != float(terms["ry"][rows["clamp_y"]])
    raw = pre.sh_ops.sh_color_unclamped(3, x["dc"], x["sh_rest"],
                                        x["xyz"] - torch_camera().cam_center)
    assert bool((raw[rows["sh_negative"]] < 0).any())


@pytest.mark.parametrize("deg", DEGREES)
def test_forward_against_jax(deg):
    import jax.numpy as jnp

    d, active, rows = scene()
    x = torch_inputs(d, grad=True)
    s = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], torch_camera(),
                       x["dc"], x["sh_rest"], deg, torch.as_tensor(active))
    want = jax_chain(deg, jnp.asarray(active))(*(jnp.asarray(d[k]) for k in INPUTS))
    groups = row_groups(rows)
    table = n(s.table)
    assert not table[-1].any()
    check_columns(table[:-1], n(want[0]), JAX_FWD_RTOL, groups, "rows")
    check_columns(n(s.depth)[:, None], n(want[1])[:, None], JAX_FWD_RTOL, groups, "depth")
    np.testing.assert_array_equal(n(s.radius), n(want[2]))
    np.testing.assert_array_equal(n(s.base_active), n(want[3]))
    np.testing.assert_array_equal(n(s.xy), table[:-1, 0:2])
    np.testing.assert_array_equal(n(s.conic), table[:-1, 2:5])


@pytest.mark.parametrize("deg", DEGREES)
def test_backward_plain_against_autograd_f64(deg):
    d, active, rows = scene()
    cam = torch_camera(torch.float64)
    x = torch_inputs(d, torch.float64, grad=True)
    g = d_attrs_for(P_SCENE, torch.float64)
    want = plain_grads(x, cam, deg, torch.as_tensor(active), g)
    got = pre.preprocess_backward_plain(*(x[k].detach() for k in INPUTS[:4]), cam,
                                        x["dc"].detach(), x["sh_rest"].detach(), deg, g)
    for name, a, b in zip(INPUTS, got, want):
        if b is None:   # sh_rest at degree 0
            b = torch.zeros_like(a)
        check_columns(n(a), n(b), GRAD_RTOL, row_groups(rows, ("det_zero",)), name)
    n_active = (deg + 1) ** 2 - 1
    assert not n(got[5])[:, n_active:].any()


@pytest.mark.parametrize("deg", DEGREES)
def test_backward_plain_against_jax_vjp(deg):
    import jax
    import jax.numpy as jnp

    d, active, rows = scene()
    g = d_attrs_for(P_SCENE)
    f = jax_chain(deg, jnp.asarray(active))
    _, pull = jax.vjp(lambda *a: f(*a)[0], *(jnp.asarray(d[k]) for k in INPUTS))
    want = pull(jnp.asarray(np.pad(n(g), ((0, 0), (0, 16 - N_ATTR)))))
    x = torch_inputs(d)
    got = pre.preprocess_backward_plain(*(x[k] for k in INPUTS[:4]), torch_camera(), x["dc"],
                                        x["sh_rest"], deg, g)
    for name, a, b in zip(INPUTS, got, want):
        check_columns(n(a), n(b), GRAD_RTOL, row_groups(rows), name)


@pytest.mark.parametrize("deg", DEGREES)
def test_function_gradient_is_autograds(deg):
    """Preprocess on CPU tensors: forward the plain chain's floats, gradient
    autograd's bit for bit."""
    d, active, _ = scene()
    cam = torch_camera()
    act = torch.as_tensor(active)
    x = torch_inputs(d, grad=True)
    g = d_attrs_for(P_SCENE)
    s = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], cam, x["dc"],
                       x["sh_rest"], deg, act)
    assert s.attrs.shape == (P_SCENE, N_ATTR) and s.attrs.grad_fn is not None
    got = torch.autograd.grad(s.attrs, [x[k] for k in INPUTS], g, allow_unused=True)
    want = plain_grads(x, cam, deg, act, g)
    for name, a, b in zip(INPUTS, got, want):
        assert (a is None and b is None) or torch.equal(a, b), name
    plain = pre.preprocess_forward_plain(*(x[k] for k in INPUTS[:4]), cam, x["dc"],
                                         x["sh_rest"], deg, act)
    for k in ("table", "depth", "radius", "base_active"):
        np.testing.assert_array_equal(n(getattr(s, k)), n(plain[k]), err_msg=k)


def test_no_grad_and_no_color_take_k5_alone():
    """Without a gradient, and in the alpha-only pass, no autograd record is
    made; no_color writes zero colours."""
    d, active, _ = scene()
    x = torch_inputs(d, grad=True)
    cam = torch_camera()
    with torch.no_grad():
        s = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], cam, x["dc"],
                           x["sh_rest"], 3)
    assert s.attrs.grad_fn is None and not s.table.requires_grad
    nc = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], cam, no_color=True)
    assert nc.attrs.grad_fn is None
    assert not n(nc.table)[:, 6:].any()
    np.testing.assert_array_equal(n(nc.table)[:, :6], n(s.table)[:, :6])


@pytest.mark.requires_cuda
class TestKernelsOnTheCard:
    """K5 and K6 on the card against their plain versions on the same card."""

    @pytest.mark.parametrize("deg", DEGREES)
    def test_k5(self, cuda_device, deg):
        d, active, rows = scene()
        x = torch_inputs(d, device=cuda_device)
        cam = torch_camera(device=cuda_device)
        act = torch.as_tensor(active, device=cuda_device)
        before = dict(pre.LAUNCHES)
        got = pre.preprocess_forward(*(x[k] for k in INPUTS[:4]), cam, x["dc"], x["sh_rest"],
                                     deg, act)
        assert pre.LAUNCHES["preprocess_forward"] == before["preprocess_forward"] + 1
        want = pre.preprocess_forward_plain(*(x[k] for k in INPUTS[:4]), cam, x["dc"],
                                            x["sh_rest"], deg, act)
        groups = row_groups(rows)
        check_columns(n(got[0]), n(want["table"]), FWD_RTOL, groups, "table")
        check_columns(n(got[1])[:, None], n(want["depth"])[:, None], FWD_RTOL, groups, "depth")
        off = np.abs(n(got[2]) - n(want["radius"]))
        assert off.max() <= 1.0 and (off > 0).sum() <= 1e-4 * P_SCENE
        np.testing.assert_array_equal(n(got[3]), n(want["base_active"]))

    @pytest.mark.parametrize("deg", DEGREES)
    def test_k6(self, cuda_device, deg):
        d, active, rows = scene()
        x = torch_inputs(d, device=cuda_device)
        cam = torch_camera(device=cuda_device)
        # a (P, 9) view of a 12-float table, as K2 hands it over
        g = torch.zeros((P_SCENE + 1, 12), device=cuda_device)
        g[:P_SCENE, :N_ATTR] = d_attrs_for(P_SCENE, device=cuda_device)
        g = g[:P_SCENE, :N_ATTR]
        args = (*(x[k] for k in INPUTS[:4]), cam, x["dc"], x["sh_rest"], deg, g)
        before = pre.LAUNCHES["preprocess_backward"]
        got = pre.preprocess_backward(*args)
        assert pre.LAUNCHES["preprocess_backward"] == before + 1
        want = pre.preprocess_backward_plain(*args)
        for name, a, b in zip(INPUTS, got, want):
            check_columns(n(a), n(b), GRAD_RTOL, row_groups(rows), name)
        xg = torch_inputs(d, device=cuda_device, grad=True)
        auto = plain_grads(xg, cam, deg, torch.as_tensor(active, device=cuda_device), g)
        for name, a, b in zip(INPUTS, got, auto):
            if b is None:   # sh_rest at degree 0
                b = torch.zeros_like(a)
            check_columns(n(a), n(b), GRAD_RTOL, row_groups(rows), name)
