"""Who owns the device's time, and how long it idles: a frozen copy of
`OWNERS`, `owner` and `idle_share` from tools/profile_torch_step.py, with
the kernel names of the port's hand-written kernels and PyTorch's own.

`busy_intervals` merges the device's kernel and copy intervals of a
profile; idle time is the window's host-timed length less their union.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

# The first pattern a kernel's name holds names its owner. Beyond the tool's
# table: the stable sort's index fill is the sort's, and PyTorch's
# contiguous copy kernel (`memcpy128`) and CUDA's `Memcpy` and `Memset`
# are copies and fills.
OWNERS = (("K1 blend forward", "blend_forward_kernel"),
          ("K2 blend backward", "blend_backward_kernel"),
          ("K5 preprocess forward", "preprocess_forward_kernel"),
          ("K6 preprocess backward", "preprocess_backward_kernel"),
          ("K7 sparse Adam", "sparse_adam_kernel"), ("K8 bin keys", "bin_keys_kernel"),
          ("K9 bin ranges", "bin_ranges_kernel"), ("K10 splat gather", "gather_splats_kernel"),
          ("K11 ssim forward", "ssim_forward_kernel"),
          ("K12 ssim backward", "ssim_backward_kernel"),
          ("sort", "radix"), ("sort", "Sort"), ("sort", "fill_reverse_indices"),
          ("gather, scatter, index", "index"), ("gather, scatter, index", "gather"),
          ("gather, scatter, index", "scatter"), ("reductions", "reduce"),
          ("copies", "copy"), ("copies", "Memcpy"), ("copies", "memcpy"),
          ("fills", "fill"), ("fills", "Memset"),
          ("elementwise", "elementwise"))

# The stages whose times and bounds the per-layer metrics compare.
STAGES = {
    "blend": ("K1 blend forward", "K2 blend backward"),
    "preprocess_adam": ("K5 preprocess forward", "K6 preprocess backward", "K7 sparse Adam"),
    "binning": ("K8 bin keys", "sort", "K9 bin ranges", "K10 splat gather"),
    "loss": ("K11 ssim forward", "K12 ssim backward"),
}


def owner(name: str) -> str:
    return next((o for o, pat in OWNERS if pat in name), "other")


def busy_intervals(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_share(spans, window: float) -> float:
    """1 - (the union of the device intervals) / (the window's length), in
    the intervals' unit; None where the trace holds no device activity."""
    merged = busy_intervals(spans)
    if not merged or window <= 0:
        return None
    return 1.0 - sum(e - s for s, e in merged) / window
