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

The stored parameters (`raw`: log_scale, quat and opa_logit, activated
inside the preprocess as GaussianMap's exp, norm chain and sigmoid) are held
the same way against JAX's activations followed by its chain, with the
stored parameters' edge rows besides (RAW_EDGES: a log scale above 88.7,
opacity logits of +inf and -inf, a zero quaternion). JAX's norm has no
gradient at 0 (NaN), PyTorch's norm backward masks it to 0, so the zero
quaternion's row is held against autograd only; float64 resolves exp(89)
(about 4.5e38) where float32 overflows, so that row is left out of the
float64 check like the needle's.

The `requires_cuda` cases hold K5 and K6 against their plain versions on the
card (K5 within 1e-6 of each column's max, from the stored parameters bit
for bit, K6 within 1e-5). JAX is imported inside the tests that use it, so
the card tests collect without it.
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
RAW_EDGES = ("exp_overflow", "opa_pos_inf", "opa_neg_inf", "zero_quat")
INPUTS = ("xyz", "scale", "quat", "opacity", "dc", "sh_rest")


def scene(seed=3, P=P_SCENE):
    """(numpy inputs of P Gaussians (>= 13), active mask, {edge: row})."""
    rng = np.random.default_rng(seed)
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


def check_columns(got, want, rtol, groups, what, nan_rows=None):
    """Each column of `got` within rtol of the column's max |want| over the
    scene's rows, and each edge row within rtol of its own max |want|; NaN
    where `want` is NaN (on `nan_rows` where given, else on every row)."""
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    held = slice(None) if nan_rows is None else nan_rows
    np.testing.assert_array_equal(np.isnan(got[held]), np.isnan(want[held]), err_msg=what)
    got, want = np.nan_to_num(got), np.nan_to_num(want)
    for name, rows in groups.items():
        scale = np.abs(want[rows]).max(0 if name == "scene" else None)
        err = np.abs(got[rows] - want[rows]).max(0)
        bad = err > rtol * scale
        assert not bad.any(), (f"{what} rows {name}: columns {np.where(bad)[0].tolist()} off by "
                               f"{(err / np.maximum(scale, 1e-300))[bad].tolist()} of their max")


def raw_scene(seed=3, P=P_SCENE):
    """scene() as stored parameters: scale and opacity hold log_scale and
    opa_logit (the logit of NaN is NaN), with RAW_EDGES at rows 14, 16, ..
    Returns (numpy inputs, active mask, {edge: row})."""
    d, active, rows = scene(seed, P)
    d = dict(d, scale=np.log(d["scale"]),
             opacity=np.log(d["opacity"] / (1.0 - d["opacity"])).astype(np.float32))
    rows.update(zip(RAW_EDGES, range(2 * len(EDGES), 2 * len(EDGES + RAW_EDGES), 2)))
    # scene()'s needle with a log scale whose exp (PyTorch's and XLA's alike,
    # 2148137.0) keeps the float32 det at exactly 0
    d["scale"][rows["det_zero"]] = [14.580111503601074, np.log(np.float32(1e-3)),
                                    np.log(np.float32(1e-3))]
    d["scale"][rows["exp_overflow"]] = [89.0, -4.0, -4.0]
    d["opacity"][rows["opa_pos_inf"]] = np.inf
    d["opacity"][rows["opa_neg_inf"]] = -np.inf
    d["quat"][rows["zero_quat"]] = 0.0
    return d, active, rows


def jax_activated(d):
    """JAX's GaussianMap activations of stored parameters (numpy in, JAX out)."""
    import jax
    import jax.numpy as jnp

    q = jnp.asarray(d["quat"])
    return dict(d, scale=jnp.exp(jnp.asarray(d["scale"])),
                quat=q / (jnp.linalg.norm(q, axis=-1, keepdims=True) + 1e-12),
                opacity=jax.nn.sigmoid(jnp.asarray(d["opacity"])))


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


def check_raw_columns(got, want, rows, leave_out, what):
    """check_columns on raw_scene()'s rows but the edge rows `leave_out`,
    which are held to nothing (module docstring says why each is left out)."""
    groups = row_groups(rows, leave_out)
    check_columns(got, want, GRAD_RTOL, groups, what,
                  nan_rows=np.concatenate(list(groups.values())))


def test_the_raw_edge_rows_are_live():
    """The stored parameters' edge rows: the needle's det is 0 after exp, a
    scale is inf, opacities 1 and 0 of the infinite logits, NaN of the NaN
    logit, a zero rotation of the zero quaternion."""
    d, _, rows = raw_scene()
    x = torch_inputs(d)
    s, q, o = pre.activate(x["scale"], x["quat"], x["opacity"])
    terms = pre.projection_terms(x["xyz"], s, q, torch_camera())
    assert float(terms["det"][rows["det_zero"]]) == 0.0
    assert bool(torch.isinf(s[rows["exp_overflow"], 0]))
    assert float(o[rows["opa_pos_inf"]]) == 1.0 and float(o[rows["opa_neg_inf"]]) == 0.0
    assert bool(torch.isnan(o[rows["nan_opacity"]]))
    assert not n(q[rows["zero_quat"]]).any()


@pytest.mark.parametrize("deg", DEGREES)
def test_raw_forward_against_jax(deg):
    """From the stored parameters: the rows, depth, radius and base_active
    against JAX's activations followed by its chain, every edge row
    included; the activated opacity against jax.nn.sigmoid."""
    import jax.numpy as jnp

    d, active, rows = raw_scene()
    x = torch_inputs(d, grad=True)
    s = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], torch_camera(),
                       x["dc"], x["sh_rest"], deg, torch.as_tensor(active), raw=True)
    act = jax_activated(d)
    want = jax_chain(deg, jnp.asarray(active))(*(jnp.asarray(act[k]) for k in INPUTS))
    groups = row_groups(rows)
    table = n(s.table)
    assert not table[-1].any()
    check_columns(table[:-1], n(want[0]), JAX_FWD_RTOL, groups, "rows")
    check_columns(n(s.depth)[:, None], n(want[1])[:, None], JAX_FWD_RTOL, groups, "depth")
    np.testing.assert_array_equal(n(s.radius), n(want[2]))
    np.testing.assert_array_equal(n(s.base_active), n(want[3]))
    check_columns(n(s.opacity)[:, None], n(act["opacity"])[:, None], JAX_FWD_RTOL, groups,
                  "opacity")
    assert s.opacity.grad_fn is None


def jax_raw_vjp(deg, d, active, g):
    """jax.vjp of JAX's activations + chain with respect to the stored
    parameters, for the rows' gradient g."""
    import jax
    import jax.numpy as jnp

    f = jax_chain(deg, jnp.asarray(active))

    def raw_rows(xyz, log_scale, quat, opa_logit, dc, sh_rest):
        act = jax_activated(dict(scale=log_scale, quat=quat, opacity=opa_logit))
        return f(xyz, act["scale"], act["quat"], act["opacity"], dc, sh_rest)[0]

    _, pull = jax.vjp(raw_rows, *(jnp.asarray(d[k]) for k in INPUTS))
    return pull(jnp.asarray(np.pad(n(g), ((0, 0), (0, 16 - N_ATTR)))))


@pytest.mark.parametrize("deg", DEGREES)
def test_raw_backward_against_jax_vjp(deg):
    """The closed form from the stored parameters against jax.vjp with
    respect to log_scale, quat and opa_logit, at GRAD_RTOL; the zero
    quaternion's row apart (JAX's norm has no gradient at 0)."""
    d, active, rows = raw_scene()
    g = d_attrs_for(P_SCENE)
    want = jax_raw_vjp(deg, d, active, g)
    x = torch_inputs(d)
    got = pre.preprocess_backward_plain(*(x[k] for k in INPUTS[:4]), torch_camera(), x["dc"],
                                        x["sh_rest"], deg, g, raw=True)
    for name, a, b in zip(INPUTS, got, want):
        check_raw_columns(n(a), n(b), rows, ("zero_quat",), name)


def raw_autograd(x, cam, deg, active, d_attrs):
    """Autograd of the plain chain with its activations, from the stored
    parameters, for the rows' gradient d_attrs."""
    rows = pre.preprocess_forward_plain(x["xyz"], x["scale"], x["quat"], x["opacity"], cam,
                                        x["dc"], x["sh_rest"], deg, active, raw=True)["rows"]
    cot = torch.nn.functional.pad(d_attrs, (0, rows.shape[1] - N_ATTR))
    return torch.autograd.grad(rows, [x[k] for k in INPUTS], cot, allow_unused=True)


@pytest.mark.parametrize("deg", DEGREES)
def test_raw_backward_plain_against_autograd(deg):
    """The closed form from the stored parameters against autograd of the
    plain chain with its activations: in float32 on every row (the zero
    quaternion's too), and against float64 autograd without the needle and
    exp(89)'s rows (module docstring)."""
    d, active, rows = raw_scene()
    act = torch.as_tensor(active)
    for dtype, leave_out in ((torch.float32, ()), (torch.float64, ("det_zero", "exp_overflow"))):
        cam = torch_camera(dtype)
        x = torch_inputs(d, dtype, grad=True)
        g = d_attrs_for(P_SCENE, dtype)
        want = raw_autograd(x, cam, deg, act, g)
        got = pre.preprocess_backward_plain(*(x[k].detach() for k in INPUTS[:4]), cam,
                                            x["dc"].detach(), x["sh_rest"].detach(), deg, g,
                                            raw=True)
        for name, a, b in zip(INPUTS, got, want):
            if b is None:   # sh_rest at degree 0
                b = torch.zeros_like(a)
            check_raw_columns(n(a), n(b), rows, leave_out, f"{name} {dtype}")
        # the opacity logit's gradient is sigmoid_backward of the row's: as autograd's
        np.testing.assert_array_equal(n(got[3]), n(want[3]), err_msg=str(dtype))


@pytest.mark.parametrize("deg", DEGREES)
def test_raw_function_gradient_is_autograds(deg):
    """Preprocess from the stored parameters on CPU tensors: forward the
    plain chain's floats with its activations, gradient autograd's bit for
    bit."""
    d, active, _ = raw_scene()
    cam = torch_camera()
    act = torch.as_tensor(active)
    x = torch_inputs(d, grad=True)
    g = d_attrs_for(P_SCENE)
    s = pre.preprocess(x["xyz"], x["scale"], x["quat"], x["opacity"], cam, x["dc"],
                       x["sh_rest"], deg, act, raw=True)
    got = torch.autograd.grad(s.attrs, [x[k] for k in INPUTS], g, allow_unused=True)
    want = raw_autograd(x, cam, deg, act, g)
    for name, a, b in zip(INPUTS, got, want):
        assert (a is None) == (b is None), name
        if a is not None:   # NaN where autograd has NaN (the inf scale's row)
            np.testing.assert_array_equal(n(a), n(b), err_msg=name)
    plain = pre.preprocess_forward_plain(*(x[k] for k in INPUTS[:4]), cam, x["dc"],
                                         x["sh_rest"], deg, act, raw=True)
    for k in ("table", "depth", "radius", "base_active", "opacity"):
        np.testing.assert_array_equal(n(getattr(s, k)), n(plain[k]), err_msg=k)


@pytest.mark.parametrize("raw", [False, True], ids=["activated", "stored"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_both_input_forms_render_alike(raw, grad):
    """render_tiled from activated values (raw=False) and from the stored
    parameters (raw=True) of one map: the same image, radii and activated
    opacity bit for bit (the activations are `activate`'s floats either
    way), and with a gradient, the stored parameters' gradients equal
    autograd through `activate` of the activated form's."""
    from gaussian_lic_tpu_torch.ops.rasterize import render_tiled

    d, active, _ = raw_scene()
    cam = torch_camera()
    x = torch_inputs(d, grad=grad)
    act = pre.activate(x["scale"], x["quat"], x["opacity"])
    geo = (x["xyz"],) + ((x["scale"], x["quat"], x["opacity"]) if raw else act)
    kw = dict(dc=x["dc"], sh_rest=x["sh_rest"], sh_degree=3, active=torch.as_tensor(active),
              tile_h=32, tile_w=32)
    with torch.set_grad_enabled(grad):
        out = render_tiled(*geo, cam, raw=raw, **kw)
        ref = render_tiled(x["xyz"], *(t.detach() for t in act), cam, **dict(kw, dc=x["dc"]))
    np.testing.assert_array_equal(n(out.image), n(ref.image))
    np.testing.assert_array_equal(n(out.radii), n(ref.radii))
    if grad:
        w = torch.as_tensor(np.random.default_rng(4).normal(size=out.image.shape),
                            dtype=torch.float32)
        got = torch.autograd.grad((out.image * w).sum(), [x[k] for k in INPUTS],
                                  allow_unused=True)
        chained = render_tiled(x["xyz"], *pre.activate(x["scale"], x["quat"], x["opacity"]),
                               cam, **kw)
        want = torch.autograd.grad((chained.image * w).sum(), [x[k] for k in INPUTS],
                                   allow_unused=True)
        for name, a, b in zip(INPUTS, got, want):
            np.testing.assert_array_equal(n(a), n(b), err_msg=name)
        assert np.nan_to_num(n(got[1])).any() and np.nan_to_num(n(got[3])).any()


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


def zeroed_rows(g, step=3):
    """g with every `step`-th row (from row 1) and the edge rows' first
    three set to 0; returns (g, the zeroed rows)."""
    rows = np.union1d(np.arange(1, g.shape[0], step), np.arange(0, 6, 2))
    g = g.clone()
    g[rows] = 0.0
    return g, rows


@pytest.mark.parametrize("deg", DEGREES)
def test_zero_gradient_rows_get_zero(deg):
    """On finite inputs (NaN opacity enters only d_opacity, which is the row
    gradient itself), a row whose nine row gradients are 0 gets exactly 0 in
    all six outputs of the closed form, as in autograd of the plain chain
    and in JAX's vjp: what K6 may write for such a row without its
    arithmetic."""
    import jax
    import jax.numpy as jnp

    d, active, _ = scene()
    g, zero = zeroed_rows(d_attrs_for(P_SCENE))
    x = torch_inputs(d)
    got = pre.preprocess_backward_plain(*(x[k] for k in INPUTS[:4]), torch_camera(), x["dc"],
                                        x["sh_rest"], deg, g)
    auto = plain_grads(torch_inputs(d, grad=True), torch_camera(), deg,
                       torch.as_tensor(active), g)
    f = jax_chain(deg, jnp.asarray(active))
    _, pull = jax.vjp(lambda *a: f(*a)[0], *(jnp.asarray(d[k]) for k in INPUTS))
    want = pull(jnp.asarray(np.pad(n(g), ((0, 0), (0, 16 - N_ATTR)))))
    live = np.setdiff1d(np.arange(P_SCENE), zero)
    for name, a, b, c in zip(INPUTS, got, auto, want):
        for what, v in (("closed form", a), ("autograd", b), ("jax.vjp", c)):
            if v is None:   # autograd's sh_rest at degree 0
                continue
            v = n(v)[zero]
            assert np.isfinite(v).all() and not v.any(), (what, name)
        if not (name == "sh_rest" and deg == 0):   # the other rows are not all zero
            assert n(a)[live].any(), name


def test_preprocess_bytes_per_row():
    """chip_smoke.preprocess_bytes, K6's bound: 504 B a Gaussian at S = 15
    (the nine row gradients 36 B, the inputs but opacity 232 B, the six
    gradients 236 B), of which sh_rest and its gradient are 360."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for P in (1, 2001, 1 << 20):
        assert cs.preprocess_bytes(P, 15)["backward"] == 504 * P
        assert cs.preprocess_bytes(P, 15)["backward"] - cs.preprocess_bytes(P, 0)["backward"] \
            == 360 * P
    assert cs.preprocess_bytes(1 << 20, 15)["backward"] == 528_482_304


@pytest.mark.parametrize("bad", ["column_stride", "float64"])
def test_k6_refuses_a_layout_it_does_not_take(bad):
    """_k6 raises, before anything is built or launched, on row gradients
    whose columns are not adjacent float32 words (any row stride is taken)."""
    d, _, _ = scene()
    x = torch_inputs(d)
    wide = d_attrs_for(P_SCENE).repeat_interleave(2, dim=1)
    g = wide[:, ::2] if bad == "column_stride" else d_attrs_for(P_SCENE, torch.float64)
    with pytest.raises(ValueError, match="d_attrs"):
        pre._k6(x["xyz"], x["scale"], x["quat"], torch_camera(), x["dc"], x["sh_rest"], 3, g)


@pytest.mark.parametrize("variant", pre.K6_VARIANTS)
def test_k6_probe_on_the_cpu(variant):
    """K6's probe wrapper on CPU tensors: base and direct (K6's outputs)
    take the closed form; the timing-only variants have no plain version
    and raise; nothing is counted."""
    d, _, _ = scene()
    x = torch_inputs(d)
    args = (*(x[k] for k in INPUTS[:4]), torch_camera(), x["dc"], x["sh_rest"], 3,
            d_attrs_for(P_SCENE))
    before = dict(pre.PROBE_LAUNCHES)
    if variant in pre.K6_TIMING_ONLY:
        with pytest.raises(ValueError, match="timing"):
            pre.preprocess_backward_probe(variant, *args)
    else:
        got = pre.preprocess_backward_probe(variant, *args)
        for a, b in zip(got, pre.preprocess_backward_plain(*args)):
            assert torch.equal(a, b)
    assert pre.PROBE_LAUNCHES == before
    with pytest.raises(ValueError, match="unknown K6 variant"):
        pre.preprocess_backward_probe(variant + "x", *args)


def k6_case(P, layout, device, off=3):
    """K6's arguments for P Gaussians of the scene, laid out as `layout`
    hands them over: `k2_table`, the row gradients as a (P, 9) view of a
    12-float table (K2's); `contiguous`, a (P, 9) tensor; `shard`, every
    parameter, sh_rest and a contiguous (P, 9) gradient as the rows
    [off, off + P) of larger tensors (a mesh rank's shard: no slab starts
    16-byte aligned). Returns (numpy inputs of the P rows, active, {edge:
    row} of the edge rows among them, the tensors (xyz, scale, quat,
    opacity, dc, sh_rest), d_attrs)."""
    lo = off if layout == "shard" else 0
    d, active, rows = scene(P=max(lo + P, 13))
    g_all = d_attrs_for(lo + P, device=device)
    x = {k: torch.as_tensor(d[k], device=device)[lo:lo + P] for k in INPUTS}
    if layout == "k2_table":
        table = torch.zeros((P + 1, 12), device=device)
        table[:P, :N_ATTR] = g_all
        g = table[:P, :N_ATTR]
    else:
        g = g_all[lo:lo + P]
    d = {k: v[lo:lo + P] for k, v in d.items()}
    edges = {k: r - lo for k, r in rows.items() if lo <= r < lo + P}
    return d, active[lo:lo + P], edges, tuple(x[k] for k in INPUTS), g


def assert_same_floats(a, b, what):
    """a and b bit for bit where either is a number (signs of zero too), NaN
    where the other is NaN."""
    if a.dtype == np.bool_:
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b), err_msg=what)
    np.testing.assert_array_equal(np.where(nan, 0, a.view(np.int32)),
                                  np.where(nan, 0, b.view(np.int32)), err_msg=what)


def case_groups(P, edges):
    normal = np.setdiff1d(np.arange(P), list(edges.values()))
    return {**({"scene": normal} if normal.size else {}),
            **{k: np.array([r]) for k, r in edges.items()}}


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

    @pytest.mark.parametrize("layout", ["k2_table", "contiguous", "shard"])
    @pytest.mark.parametrize("deg", DEGREES)
    @pytest.mark.parametrize("P", [1, 3, 129, 2001])
    def test_k6_blocks_and_layouts(self, cuda_device, P, deg, layout):
        """K6 on tail blocks (P of 1, 3, 129, 2001: slabs that are no
        multiple of 16 B), every degree, and the layouts the main and the
        mesh path hand it (k6_case), against the closed form and autograd
        of the plain chain at GRAD_RTOL, one launch a call."""
        d, active, edges, ins, g = k6_case(P, layout, cuda_device)
        cam = torch_camera(device=cuda_device)
        args = (*ins[:4], cam, ins[4], ins[5], deg, g)
        before = pre.LAUNCHES["preprocess_backward"]
        got = pre.preprocess_backward(*args)
        torch.cuda.synchronize()
        assert pre.LAUNCHES["preprocess_backward"] == before + 1
        groups = case_groups(P, edges)
        for name, a, b in zip(INPUTS, got, pre.preprocess_backward_plain(*args)):
            check_columns(n(a), n(b), GRAD_RTOL, groups, name)
        xg = torch_inputs(d, device=cuda_device, grad=True)
        auto = plain_grads(xg, cam, deg, torch.as_tensor(active, device=cuda_device),
                           g.contiguous())
        for name, a, b in zip(INPUTS, got, auto):
            if b is None:   # sh_rest at degree 0
                b = torch.zeros_like(a)
            check_columns(n(a), n(b), GRAD_RTOL, groups, name)

    @pytest.mark.parametrize("variant", pre.K6_VARIANTS)
    def test_k6_probe_variants(self, cuda_device, variant):
        """K6's timing variants launch, count, and return K6's shapes; base
        and direct equal K6 bit for bit, on a shard's layout too."""
        for layout in ("k2_table", "shard"):
            _, _, _, ins, g = k6_case(2001, layout, cuda_device)
            args = (*ins[:4], torch_camera(device=cuda_device), ins[4], ins[5], 3, g)
            want = pre.preprocess_backward(*args)
            before = pre.PROBE_LAUNCHES[variant]
            got = pre.preprocess_backward_probe(variant, *args)
            torch.cuda.synchronize()
            assert pre.PROBE_LAUNCHES[variant] == before + 1
            assert [a.shape for a in got] == [b.shape for b in want]
            if variant not in pre.K6_TIMING_ONLY:
                for a, b in zip(got, want):
                    assert torch.equal(a, b), layout

    @pytest.mark.parametrize("deg", DEGREES)
    def test_k5_from_the_stored_parameters(self, cuda_device, deg):
        """K5 from the stored parameters, bit for bit with the plain chain
        and its activations on the same card (its exp, norm and sigmoid are
        CUDA's torch.exp, norm chain and torch.sigmoid), every edge row
        included; the activated opacity too."""
        d, active, _ = raw_scene()
        x = torch_inputs(d, device=cuda_device)
        cam = torch_camera(device=cuda_device)
        act = torch.as_tensor(active, device=cuda_device)
        args = (*(x[k] for k in INPUTS[:4]), cam, x["dc"], x["sh_rest"], deg, act)
        before = pre.LAUNCHES["preprocess_forward"]
        got = pre.preprocess_forward(*args, raw=True)
        assert pre.LAUNCHES["preprocess_forward"] == before + 1
        want = pre.preprocess_forward_plain(*args, raw=True)
        for k, a in zip(("table", "depth", "radius", "base_active", "opacity"), got):
            assert_same_floats(n(a), n(want[k]), k)

    @pytest.mark.parametrize("layout", ["k2_table", "shard"])
    @pytest.mark.parametrize("deg", DEGREES)
    def test_k6_from_the_stored_parameters(self, cuda_device, deg, layout):
        """K6 from the stored parameters against the closed form and
        autograd of the plain chain with its activations at GRAD_RTOL (the
        opacity logit's gradient bit for bit with autograd's), on K2's
        layout and a shard's; base and direct of its probe bit for bit."""
        lo = 3 if layout == "shard" else 0
        d, active, rows = raw_scene(P=P_SCENE + lo)
        x = {k: torch.as_tensor(d[k], device=cuda_device)[lo:] for k in INPUTS}
        d = {k: v[lo:] for k, v in d.items()}
        rows = {k: r - lo for k, r in rows.items() if r >= lo}
        cam = torch_camera(device=cuda_device)
        g = torch.zeros((P_SCENE + 1, 12), device=cuda_device)
        g[:P_SCENE, :N_ATTR] = d_attrs_for(P_SCENE, device=cuda_device)
        g = g[:P_SCENE, :N_ATTR]
        args = (*(x[k] for k in INPUTS[:4]), cam, x["dc"], x["sh_rest"], deg, g)
        before = pre.LAUNCHES["preprocess_backward"]
        got = pre.preprocess_backward(*args, raw=True)
        torch.cuda.synchronize()
        assert pre.LAUNCHES["preprocess_backward"] == before + 1
        groups = case_groups(P_SCENE, rows)
        for name, a, b in zip(INPUTS, got, pre.preprocess_backward_plain(*args, raw=True)):
            check_columns(n(a), n(b), GRAD_RTOL, groups, name)
        xg = torch_inputs(d, device=cuda_device, grad=True)
        auto = raw_autograd(xg, cam, deg, torch.as_tensor(active[lo:], device=cuda_device),
                            g.contiguous())
        for name, a, b in zip(INPUTS, got, auto):
            if b is None:   # sh_rest at degree 0
                b = torch.zeros_like(a)
            check_columns(n(a), n(b), GRAD_RTOL, groups, name)
        np.testing.assert_array_equal(n(got[3]), n(auto[3]))
        for v in ("base", "direct"):
            for a, b in zip(pre.preprocess_backward_probe(v, *args, raw=True), got):
                assert_same_floats(n(a), n(b), v)
