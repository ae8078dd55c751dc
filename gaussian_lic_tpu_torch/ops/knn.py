"""k-nearest-neighbour mean squared distance, for the skybox's scales.

The counterpart of the JAX package's `ops/knn.py` (reference simple-knn,
`distCUDA2`, simple_knn.cu:45-221): the mean squared distance from each point
to its 3 nearest neighbours. Exact brute force for n <= 2048; above that a
Morton-sorted window search over the +-16 neighbours in Morton order, the
same candidates as the JAX version (a stable argsort, so tied codes keep
their index order).
"""

from __future__ import annotations

import torch

_K = 3  # simple-knn hardcodes 3 neighbours
BRUTE_FORCE_MAX = 2048


def _morton_10bit(pts01: torch.Tensor) -> torch.Tensor:
    """Interleave 10-bit quantized coords into a 30-bit Morton code
    (coord2Morton, simple_knn.cu:45-70), in int64."""
    q = torch.clamp(pts01 * 1023.0, 0, 1023).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def _mean_k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(d2, k, dim=-1, largest=False).values.mean(dim=-1)


def mean_knn_dist2_bruteforce(points: torch.Tensor, k: int = _K) -> torch.Tensor:
    """Exact O(n^2): mean squared distance to the k nearest neighbours."""
    d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    d2.fill_diagonal_(float("inf"))  # exclude self
    return _mean_k_smallest(d2, k)


def mean_knn_dist2_sorted(points: torch.Tensor, k: int = _K, window: int = 16) -> torch.Tensor:
    """Morton-sorted window kNN: the candidates are the +-window neighbours
    in Morton order. O(n * window)."""
    n = points.shape[0]
    lo = points.amin(0)
    hi = points.amax(0)
    pts01 = (points - lo) / torch.clamp_min(hi - lo, 1e-12)
    order = torch.argsort(_morton_10bit(pts01), stable=True)
    sorted_pts = points[order]

    # (n, 2*window) candidate indices into the sorted array; out-of-range
    # slots are masked to +inf, not clamped (a clamped slot would repeat a
    # candidate and bias the mean low)
    dev = points.device
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    raw = torch.arange(n, device=dev)[:, None] + offs[None, :]
    in_range = (raw >= 0) & (raw < n)
    diff = sorted_pts[:, None, :] - sorted_pts[raw.clamp(0, n - 1)]
    d2 = torch.where(in_range, (diff * diff).sum(-1), torch.full_like(diff[..., 0], float("inf")))
    mean_sorted = _mean_k_smallest(d2, k)
    out = torch.empty_like(mean_sorted)
    out[order] = mean_sorted  # undo the sort
    return out


def mean_knn_dist2(points: torch.Tensor, k: int = _K) -> torch.Tensor:
    """distCUDA2 equivalent (spatial.cu:15-26): brute force for small n, the
    Morton-window search otherwise."""
    if points.shape[0] <= BRUTE_FORCE_MAX:
        return mean_knn_dist2_bruteforce(points, k)
    return mean_knn_dist2_sorted(points, k)
