"""Multi-GPU rendering and training over a `torch.distributed` process group.

The counterpart of the JAX package's `parallel/sharded.py`, which runs the same
design inside `jax.shard_map` over a `jax.sharding.Mesh`:

  * Tile-row bands: the tile grid is split into D horizontal bands of
    `band_n_ty` tile rows, one per rank; each rank blends only its band (K1
    and K2 on a band-local grid). `_band_geometry` picks a tile shape whose
    row count the ranks divide: the configured tile, else (16,64), else
    (8,128).
  * Sharded map: each rank holds rows [r C/D, (r+1) C/D) of every Gaussian
    tensor and of the Adam moments (C the capacity); preprocess (projection,
    EWA, SH: K5/K6 on the card) and sparse Adam (K7) run on the shard.
  * One all_gather of the packed (C/D, 16) splat rows gives every band owner
    the whole table; the reduce-scatter of the rows' (C, 9) gradient
    (`gather_grad`) sums every band's gradient into the owner's shard (JAX:
    the all_gather transpose).
  * Distributed binning (`bin_gaussians_sharded`): each rank enumerates and
    culls the tile slots of its Gaussian shard with GLOBAL tile ids, one sort
    groups them by destination band, fixed-size buckets of m_pair entries go
    to the band owners by all_to_all, and each owner merges its D streams
    ordered by (key, k-major slot id), which is the single-device order.
  * Loss: when the bands cover whole image rows (H == padded height) each
    rank takes its band's L1 + SSIM part after a HALO-row exchange with its
    neighbours (`ops.losses.training_loss_band_part`); otherwise the image is
    gathered and every rank takes the full loss / D.
  * Exposure is replicated: its gradient is summed over the ranks and every
    rank takes the same dense Adam step. Metrics are summed over the ranks.

`make_sharded_train_bundle` runs k sharded steps as one dispatch (JAX: one
`lax.scan` inside `shard_map`): on the card one CUDA graph of the k steps,
their NCCL collectives included, replayed from the engine's `BundleGraphs`.

Not ported: `mesh_interpret` (Pallas interpret mode on CPU meshes; the port's
kernels take the plain versions for CPU tensors).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from gaussian_lic_tpu_torch.camera import Camera, Intrinsics
from gaussian_lic_tpu_torch.config import Params
from gaussian_lic_tpu_torch.engine.trainer import PARAM_GROUPS, BundleGraphs, _bundle_of
from gaussian_lic_tpu_torch.models.gaussians import GaussianMap, LearningRates
from gaussian_lic_tpu_torch.ops import adam as adam_ops
from gaussian_lic_tpu_torch.ops import losses
from gaussian_lic_tpu_torch.ops import tiles as tiles_ops
from gaussian_lic_tpu_torch.ops.blend import ROW_Y, SPLAT_ROWS
from gaussian_lic_tpu_torch.ops.erank import erank_regularizer
from gaussian_lic_tpu_torch.ops.preprocess import preprocess
from gaussian_lic_tpu_torch.ops.rasterize import CHUNK, _Blend, _splat_budget_for, expose
from gaussian_lic_tpu_torch.parallel.collectives import (
    all_gather, all_reduce_sum, gather_dim0, gather_grad, halo_exchange,
)
from gaussian_lic_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclass(frozen=True)
class Mesh:
    """The ranks of a sharded run: the process group, this process's rank
    in it, its size, the global ranks of its members and this rank's device."""

    group: object
    rank: int
    size: int
    ranks: Tuple[int, ...]
    device: torch.device


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device] = DEFAULT_DEVICE) -> Mesh:
    """The mesh of the current process group (parallel.launch.spawn starts
    one). Without one, and for one device, makes a one-rank group (NCCL on
    the card, gloo on the CPU) over a FileStore in a temp dir. Raises when
    more ranks are asked for than the group has, or fewer."""
    dev = resolve_device(device, "make_mesh")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} devices, have 1 (no process group: "
                             "start the ranks with gaussian_lic_tpu_torch.parallel.launch.spawn)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="glic_mesh_"), "store"), 1)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                                rank=0, world_size=1)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} devices, have {size} ranks in the process group")
    group = dist.group.WORLD
    return Mesh(group=group, rank=dist.get_rank(), size=size,
                ranks=tuple(dist.get_process_group_ranks(group)), device=dev)


def bin_gaussians_sharded(
    xy, depth, conic, opacity, radius, active,
    grid: tiles_ops.TileGrid,
    *,
    mesh: Mesh,
    band_n_ty: int,
    max_tiles_per_gaussian: int,
    m_pair: int,                  # per (source, band) bucket budget
    align: int,
    sharded_inputs: bool = False,  # True: inputs are this rank's (P/D,) shard
):
    """Distributed tile binning: every rank enumerates and culls the slots of
    its P/D Gaussian shard across ALL bands (global tile ids), one stable
    sort groups them by (band, tile, depth), buckets of `m_pair` entries per
    destination band go to their owners by all_to_all, and each owner merges
    its D streams by (key, k-major slot id), which reproduces bin_gaussians'
    order on the whole image. Returns this rank's band-local (sorted_gauss,
    tile_starts, tile_lens, cnt, num_valid, budget_lost, truncated);
    budget_lost (the entries past a full bucket) and truncated (the rect
    tiles past the K-slot cap) are this rank's send-side partials, to be
    summed over the ranks."""
    K = max_tiles_per_gaussian
    D = mesh.size
    if sharded_inputs:
        shard = xy.shape[0]
        P = shard * D
    else:
        P = xy.shape[0]
        assert P % D == 0, "Gaussian capacity must divide the mesh"
        shard = P // D
    dev = xy.device
    tiles_per_band = band_n_ty * grid.n_tx
    # depth bits of the whole grid: the same truncation, so the same ties, as
    # bin_gaussians on the whole image
    depth_bits = tiles_ops.rank_bits_for(grid.n_ty * grid.n_tx)
    g0 = mesh.rank * shard

    live = active & (radius > 0.0)
    if not sharded_inputs:
        xy, depth, conic, opacity, radius, live = (
            a[g0:g0 + shard] for a in (xy, depth, conic, opacity, radius, live))
    keys, _, truncated = tiles_ops.compute_slot_keys_kmajor(
        xy, tiles_ops.depth_key(depth, depth_bits), conic, opacity, radius, live, grid, K,
        depth_bits,
    )
    # global k-major slot ids k P + p: ties ordered by them are bin_gaussians'
    slot = (torch.arange(K, dtype=torch.int64, device=dev)[:, None] * P + g0
            + torch.arange(shard, dtype=torch.int64, device=dev)[None, :]).reshape(-1)
    pk, order = torch.sort(keys, stable=True)
    sk = slot[order]

    # fixed-size per-band buckets; band b's keys start at its first tile's
    band_bounds = (torch.arange(D + 1, dtype=torch.int64, device=dev) * tiles_per_band) << depth_bits
    edges = torch.searchsorted(pk, band_bounds, side="left")
    q = torch.arange(D * m_pair, device=dev)
    b_of_q = torch.div(q, m_pair, rounding_mode="floor")
    off = q - b_of_q * m_pair
    valid_q = off < edges[b_of_q + 1] - edges[b_of_q]
    src = torch.clamp(edges[b_of_q] + off, 0, shard * K - 1)
    send_keys = torch.where(valid_q, pk[src], tiles_ops.INVALID_KEY)
    send_slots = torch.where(valid_q, sk[src], -1)
    budget_lost = torch.clamp_min(edges[1:] - edges[:-1] - m_pair, 0).sum().to(torch.int32)

    recv_keys = torch.empty_like(send_keys)
    recv_slots = torch.empty_like(send_slots)
    dist.all_to_all_single(recv_keys, send_keys, group=mesh.group)
    dist.all_to_all_single(recv_slots, send_slots, group=mesh.group)

    # merge by (key, slot): torch sorts on one key, and key and slot do not
    # fit one int64, so a stable sort by slot, then a stable sort by key
    by_slot = torch.sort(recv_slots, stable=True).indices
    fk, by_key = torch.sort(recv_keys[by_slot], stable=True)
    fs = recv_slots[by_slot][by_key]
    m_eff = D * m_pair
    M_pad = (m_eff + align - 1) // align * align
    present = fk != tiles_ops.INVALID_KEY
    # K9 on the card: the Gaussian of every entry, the band's tile ranges
    # (its tiles' global ids from its first) and the entries per Gaussian in
    # this band's list (the port's K2 sums with atomics and never reads
    # them; kept for parity with bin_gaussians)
    sorted_gauss, tile_starts, tile_lens, cnt = tiles_ops.bin_ranges(
        tiles_ops.keys_to_int32(fk), fs, m_eff, M_pad, P, tiles_per_band, depth_bits,
        tile0=mesh.rank * tiles_per_band)
    return (sorted_gauss, tile_starts, tile_lens, cnt,
            present.sum(dtype=torch.int32), budget_lost, truncated)


def _m_pair(m_local: int, n_dev: int, bucket_overprovision: float) -> int:
    """Bucket budget per (source, band): the band's share of the splat
    budget times `bucket_overprovision`, split over the D sources, rounded
    down to 256, at least 512."""
    return max(-(-int(bucket_overprovision * m_local) // n_dev) // 256 * 256, 512)


def _band_grid(grid: tiles_ops.TileGrid, band_n_ty: int) -> tiles_ops.TileGrid:
    """The band-local grid the blend kernels run on: band_n_ty tile rows."""
    return tiles_ops.TileGrid(width=grid.width, height=band_n_ty * grid.tile_h,
                              tile_w=grid.tile_w, tile_h=grid.tile_h)


def render_band(
    xyz: torch.Tensor,
    log_scale: torch.Tensor,
    quat: torch.Tensor,
    opa_logit: torch.Tensor,
    camera: Camera,
    *,
    dc: torch.Tensor,
    sh_rest: torch.Tensor,
    sh_degree: int,
    active: torch.Tensor,
    band_ty0: int,           # first tile row of this band
    band_n_ty: int,          # tile rows per band
    tile_h: int,
    tile_w: int,
    max_tiles_per_gaussian: int,
    max_total_splats: int,   # per-band splat budget
    mesh: Optional[Mesh] = None,   # set, D > 1: distributed binning over the mesh
    bucket_overprovision: float = 2.0,
):
    """Differentiable render of one band of tile rows: (color (3, band_n_ty
    tile_h, Wp), final_T, visible (P,), budget_lost, truncated). The math of
    ops.rasterize.render_tiled restricted to the band. With a mesh of more
    than one rank the binning is distributed and the overflow counters are
    this rank's partials; otherwise the band is binned here (bin_gaussians
    with band_ty0/band_n_ty and the whole grid's depth bits, so the bands
    stitched are the whole image's render). It takes the stored parameters,
    log_scale, quat and opa_logit: K5 applies the activations."""
    intr = camera.intr
    grid = tiles_ops.TileGrid(width=intr.width, height=intr.height, tile_w=tile_w,
                              tile_h=tile_h)
    s = preprocess(xyz, log_scale, quat, opa_logit, camera, dc=dc, sh_rest=sh_rest,
                   sh_degree=sh_degree, active=active, raw=True)
    visible = s.radius > 0.0

    detached = (s.xy, s.depth, s.conic, s.opacity, s.radius, s.base_active)
    if mesh is not None and mesh.size > 1:
        sorted_gauss, tile_starts, tile_lens, _, _, budget_lost, truncated = (
            bin_gaussians_sharded(
                *detached, grid, mesh=mesh, band_n_ty=band_n_ty,
                max_tiles_per_gaussian=max_tiles_per_gaussian,
                m_pair=_m_pair(max_total_splats, mesh.size, bucket_overprovision),
                align=CHUNK,
            ))
    else:
        # the whole grid's depth bits: the band's entries keep the whole
        # image's order, ties included, as the distributed binning's do
        b = tiles_ops.bin_gaussians(
            *detached, grid, max_tiles_per_gaussian=max_tiles_per_gaussian,
            max_total_splats=max_total_splats, band_ty0=band_ty0, band_n_ty=band_n_ty,
            align=CHUNK, depth_bits=tiles_ops.rank_bits_for(grid.num_tiles),
        )
        sorted_gauss, tile_starts, tile_lens = b.sorted_gauss, b.tile_starts, b.tile_lens
        budget_lost, truncated = b.budget_lost, b.truncated
    table = _band_table(s.table[:-1], float(band_ty0 * tile_h))
    color, final_t, _ = _Blend.apply(s.attrs, sorted_gauss, tile_starts, tile_lens,
                                     _band_grid(grid, band_n_ty), table)
    return color, final_t, visible, budget_lost, truncated


def _band_table(rows: torch.Tensor, y_off: float) -> torch.Tensor:
    """(P+1, 16): splat rows (P, 16) in band-local pixel coordinates (y
    shifted by the band's first pixel row, a constant transparent to the
    gradient) and the dead id's zero row. The shift is made on the device:
    a host-to-device copy is refused inside a CUDA graph capture."""
    table = rows.new_zeros((rows.shape[0] + 1, SPLAT_ROWS))
    shift = torch.where(torch.arange(SPLAT_ROWS, device=rows.device) == ROW_Y, -y_off, 0.0)
    torch.add(rows, shift, out=table[:-1])
    return table


def _band_geometry(intr: Intrinsics, cfg: Params, n_dev: int):
    """(grid, band_n_ty): a tile shape whose row count the ranks divide.
    The configured tile first (least splat-tile overlap), then the flatter
    1024-pixel tiles (16,64) and (8,128) for short images; K1 picks its warp
    blocks from the tile's shape (ops.blend.k1_block)."""
    for th, tw in [(cfg.tile_h, cfg.tile_w), (16, 64), (8, 128)]:
        grid = tiles_ops.TileGrid(width=intr.width, height=intr.height, tile_w=tw, tile_h=th)
        if grid.n_ty % n_dev == 0:
            return grid, grid.n_ty // n_dev
    raise ValueError(
        f"no 1024-pixel tile shape gives tile rows divisible by the mesh "
        f"({n_dev} devices, image {intr.width}x{intr.height}); pad the "
        f"image height to a multiple of {8 * n_dev}"
    )


def shard_state(gm: GaussianMap, opt_state: dict, mesh: Mesh):
    """This rank's shard of a map every rank holds whole, and of its Adam
    moments: rows [r C/D, (r+1) C/D) of each Gaussian tensor (views; no
    communication). The count, exposure and its moments stay whole."""
    assert gm.capacity % mesh.size == 0, "Gaussian capacity must divide the mesh"
    n = gm.capacity // mesh.size
    sl = slice(mesh.rank * n, (mesh.rank + 1) * n)
    gm_s = gm.with_trainable({k: v[sl] for k, v in gm.trainable().items()})
    opt_s = {k: (adam_ops.AdamState(st.exp_avg[sl], st.exp_avg_sq[sl])
                 if k in PARAM_GROUPS else st) for k, st in opt_state.items()}
    return gm_s, opt_s


def gather_state(gm_s: GaussianMap, opt_s: dict, mesh: Mesh):
    """The whole map and moments on every rank from each rank's shard: one
    all_gather per tensor."""
    gm = gm_s.with_trainable({k: gather_dim0(v, mesh) for k, v in gm_s.trainable().items()})
    opt = {k: (adam_ops.AdamState(gather_dim0(st.exp_avg, mesh), gather_dim0(st.exp_avg_sq, mesh))
               if k in PARAM_GROUPS else st) for k, st in opt_s.items()}
    return gm, opt


def make_sharded_train_step(intr: Intrinsics, cfg: Params, mesh: Mesh,
                            with_grads: bool = False):
    """The sharded train step, (gm_s, opt_s, kf, idx, exp_step) -> (gm_s',
    opt_s', metrics), the counterpart of engine.trainer.train_step on this
    rank's shard (`shard_state`): gm_s holds rows [r C/D, (r+1) C/D) of the
    map with the map's count and exposure. Metrics are summed over the ranks
    (loss, n_visible, overflow, budget_lost, truncated); `with_grads` adds
    the pre-Adam gradients of the whole map (gathered; parity checks only).
    Every rank must call it with the same keyframe and step."""
    D = mesh.size
    grid, band_n_ty = _band_geometry(intr, cfg, D)
    band_grid = _band_grid(grid, band_n_ty)
    tile_h = grid.tile_h
    band_h = band_n_ty * tile_h
    H, W = intr.height, intr.width
    # the band loss needs every band row to be an image row; a padded grid
    # takes the gathered image and the replicated loss instead
    band_loss = H == grid.padded_height
    lrs = LearningRates.from_params(cfg)
    lr_map = dict(xyz=lrs.xyz, dc=lrs.dc, sh_rest=lrs.sh_rest, opacity=lrs.opacity,
                  log_scale=lrs.log_scale, quat=lrs.quat)
    K = cfg.max_tiles_per_gaussian

    def step(gm_s: GaussianMap, opt_state: dict, kf, idx: int, exp_step: int):
        shard = gm_s.capacity
        dev = gm_s.device
        g0 = mesh.rank * shard
        active_s = torch.arange(g0, g0 + shard, device=dev) < gm_s.count
        y_off = float(mesh.rank * band_h)
        cam = kf.camera(intr, idx)
        gt = kf.image(idx).float() / 255.0
        m_local = max(_splat_budget_for(shard * D, cfg) // D, 1 << 10)
        m_pair = _m_pair(m_local, D, cfg.bucket_overprovision)

        trainable = {k: v.detach().requires_grad_(True) for k, v in gm_s.trainable().items()}
        leaves = [trainable[name] for name in PARAM_GROUPS]
        exposure = None
        if cfg.apply_exposure:
            exposure = gm_s.exposure.detach().requires_grad_(True)
            leaves.append(exposure)

        # the stored parameters: K5 applies the activations, K6 chains their
        # backward (train_step's render_map likewise)
        s = preprocess(trainable["xyz"], trainable["log_scale"], trainable["quat"],
                       trainable["opacity"], cam, dc=trainable["dc"],
                       sh_rest=trainable["sh_rest"], sh_degree=gm_s.sh_degree, active=active_s,
                       raw=True)
        visible_s = s.radius > 0.0
        # every rank's rows, shifted into this band's pixel rows; the rows'
        # gradient goes back to its shard through gather_grad's reduce-scatter
        table = _band_table(gather_dim0(s.table[:-1], mesh), y_off)
        attrs = gather_grad(s.attrs, mesh)

        sorted_gauss, tile_starts, tile_lens, _, _, budget_lost, truncated = (
            bin_gaussians_sharded(
                s.xy, s.depth, s.conic, s.opacity, s.radius, s.base_active, grid,
                mesh=mesh, band_n_ty=band_n_ty, max_tiles_per_gaussian=K, m_pair=m_pair,
                align=CHUNK, sharded_inputs=True,
            ))
        color_l, _, _ = _Blend.apply(attrs, sorted_gauss, tile_starts, tile_lens, band_grid,
                                     table)
        if band_loss:
            # the band's loss part after a HALO-row exchange with the
            # neighbours (zeros at the image's edges: SSIM's zero padding)
            image_b = color_l[:, :, :W]
            if exposure is not None:
                image_b = expose(image_b, exposure)
            up, dn = halo_exchange(image_b, losses.HALO, mesh)
            rendered_ext = torch.cat([up, image_b, dn], dim=1)
            gt_pad = F.pad(gt, (0, 0, losses.HALO, losses.HALO))
            gt_ext = gt_pad[:, mesh.rank * band_h:(mesh.rank + 1) * band_h + 2 * losses.HALO]
            # the parts sum to training_loss - lambda; lambda is added back
            # to the metric below
            loss = losses.training_loss_band_part(rendered_ext, gt_ext, 3 * H * W,
                                                  cfg.lambda_dssim)
        else:
            # 1/D: every rank's identical image cotangent is summed by the
            # gathers' reduce-scatters
            img = all_gather(color_l.transpose(0, 1), mesh).transpose(0, 1)
            image = img[:, :H, :W]
            if exposure is not None:
                image = expose(image, exposure)
            loss = losses.training_loss(image, gt, cfg.lambda_dssim) / D
        if cfg.lambda_erank > 0:
            # the shard's part: gradients reach only this shard's scales
            loss = loss + erank_regularizer(torch.exp(trainable["log_scale"]),
                                            cfg.lambda_erank)
        grad_list = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {name: torch.zeros_like(leaf) if g is None else g
                 for name, leaf, g in zip(PARAM_GROUPS + ("exposure",), leaves, grad_list)}

        visible_s = visible_s & active_s
        with torch.no_grad():
            new_trainable, new_opt = adam_ops.sparse_adam_update_groups(
                {name: trainable[name].detach() for name in PARAM_GROUPS}, grads,
                {name: opt_state[name] for name in PARAM_GROUPS}, visible_s, lr_map)
            gm_new = gm_s.with_trainable(new_trainable)
            # one sum over the ranks: loss, counters and the exposure gradient
            sums = [loss.detach().double().reshape(1),
                    torch.stack([visible_s.sum().double(), budget_lost.double(),
                                 truncated.double()])]
            if exposure is not None:
                sums.append(grads["exposure"].double().reshape(-1))
            total = all_reduce_sum(torch.cat(sums), mesh)
            if exposure is not None:
                exp_grad = total[4:].float().reshape(3, 4)
                exp_p, new_opt["exposure"] = adam_ops.dense_adam_update(
                    gm_s.exposure, exp_grad, opt_state["exposure"], lr=cfg.exposure_lr,
                    step_count=exp_step)
                gm_new = gm_new.replace(exposure=exp_p)
            elif "exposure" in opt_state:
                new_opt["exposure"] = opt_state["exposure"]
            counts = total[1:4].to(torch.int32)
            metrics = {
                "loss": (total[0] + (cfg.lambda_dssim if band_loss else 0.0)).float(),
                "n_visible": counts[0],
                "overflow": counts[1] + counts[2],
                "budget_lost": counts[1],
                "truncated": counts[2],
            }
            if with_grads:
                metrics["grads"] = {name: gather_dim0(grads[name], mesh)
                                    for name in PARAM_GROUPS}
        return gm_new, new_opt, metrics

    return step


def make_sharded_train_bundle(intr: Intrinsics, cfg: Params, mesh: Mesh, k: int,
                              graphs: Optional[BundleGraphs] = None):
    """k sharded train steps as one dispatch, the twin of
    engine.trainer._make_train_bundle with the signature of the sharded
    step: (gm_s, opt_s, kf, idxs (k,), es0) -> (gm_s', opt_s', metrics) on
    this rank's shard (`shard_state`), step i on keyframe idxs[i] with
    exposure step es0 + i, metrics aggregated as JAX's bundle does (loss and
    n_visible of the last step, visible_sum summed, budget_lost and
    truncated maxed, overflow their sum).

    CPU tensors (gloo) run the k eager sharded steps, the same floats as k
    calls of make_sharded_train_step. CUDA tensors on an NCCL group run one
    CUDA graph of the k steps, collectives included, captured against the
    static shard of `graphs` (an engine's; a private set when None) and
    replayed; on any other group they raise. Every rank must call it with
    the same keyframe ids and step."""
    return _bundle_of(make_sharded_train_step(intr, cfg, mesh), cfg, k, graphs, mesh)


def make_sharded_render(intr: Intrinsics, cfg: Params, mesh: Mesh):
    """The sharded forward render, (gm, kf, idx) -> the whole (3, H, W)
    image and (H, W) final_T on every rank: the bands render in parallel
    (distributed binning over the mesh) and one gather stitches them. Every
    rank holds the whole map."""
    D = mesh.size
    grid, band_n_ty = _band_geometry(intr, cfg, D)
    H, W = intr.height, intr.width

    @torch.no_grad()
    def render(gm: GaussianMap, kf, idx: int):
        m_local = max(_splat_budget_for(gm.capacity, cfg) // D, 1 << 10)
        color_l, final_t_l, _, _, _ = render_band(
            gm.xyz, gm.log_scale, gm.quat, gm.opa_logit, kf.camera(intr, idx),
            dc=gm.dc, sh_rest=gm.sh_rest, sh_degree=gm.sh_degree, active=gm.active_mask(),
            band_ty0=mesh.rank * band_n_ty, band_n_ty=band_n_ty, tile_h=grid.tile_h,
            tile_w=grid.tile_w, max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            max_total_splats=m_local, mesh=mesh,
            bucket_overprovision=cfg.bucket_overprovision,
        )
        img = gather_dim0(color_l.transpose(0, 1), mesh).transpose(0, 1)[:, :H, :W]
        return img, gather_dim0(final_t_l, mesh)[:H, :W]

    return render
