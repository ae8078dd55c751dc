"""Stage bounds of one train step: the least time the published peaks of an
H100 allow for what each stage's inputs need, never for what today's
kernels happen to move.

Each bound is the larger of the operations' time and the bytes' time, with
each input read once and each output written once. The operation counts of
the blend are the pairs the result needs (the arithmetic of
`blend_pairs` and `bound_ms` in chip_smoke.py, frozen here): a forward
pair that a pixel tests costs 19 FP32 instructions and one MUFU (the exp),
an applied pair 7 more; a backward pair that a pixel applied costs 45 FP32
instructions and 2 MUFU (the exp and the reciprocal). The SSIM's are
K11's 272 FP32 and 4 MUFU and K12's 134 FP32 a pixel and channel. The
per-Gaussian stages are bounded by their bytes.

Stages and what they must move (P rows, `live` of them Gaussians, `vis`
visible in the view, `m` entries in the cut list, T tiles, N pixels):

  blend           forward: the list's 9 used floats an entry and the tile
                  ranges read, colour, final T and n_contrib written; backward:
                  the list, its ids, the ranges, dL/dpixel, final T and n_contrib
                  read, the visible Gaussians' 9 row gradients written;
  preprocess_adam the live rows' stored parameters read (59 floats) and the
                  visible rows' packed row (9 floats) with depth and radius of
                  every live row written; the visible rows' row gradients and
                  parameters read and their parameter gradients written; Adam
                  on the visible rows only: p, g, m, v read, p, m, v written;
  binning         the live Gaussians' mean, conic, depth, opacity, radius and
                  flag read (33 B), the cut list's ids and gathered 9-float
                  rows and the tile ranges written (not the P K slots);
  loss            the image and the uint8 target read, d image written.
"""

from __future__ import annotations

FP32_FLOPS = 67e12                  # H100 SXM, FP32 outside the tensor cores
FP32_INSTR_PER_S = FP32_FLOPS / 2   # an FMA counts 2 FLOPs
MUFU_PER_S = FP32_INSTR_PER_S / 8   # 16 special-function lanes an SM to 128 FP32
HBM_BYTES_PER_S = 3.35e12

PARAM_FLOATS = 59                   # xyz 3, dc 3, sh_rest 45, opacity 1, scale 3, quat 4
ROW_FLOATS = 9
PAIR_FORWARD = (19, 7, 1)           # FP32 a tested pair, FP32 more an applied, MUFU
PAIR_BACKWARD = (45, 2)             # FP32, MUFU an applied pair
SSIM_FP32, SSIM_MUFU = 272 + 134, 4


def seconds(fp32: float = 0.0, mufu: float = 0.0, nbytes: float = 0.0) -> float:
    return max(fp32 / FP32_INSTR_PER_S, mufu / MUFU_PER_S, nbytes / HBM_BYTES_PER_S)


def blend(c: dict) -> float:
    tested = c["applied"] + c["stopped"]
    fwd = seconds(PAIR_FORWARD[0] * tested + PAIR_FORWARD[1] * c["applied"],
                  PAIR_FORWARD[2] * tested,
                  c["entries"] * 4 * ROW_FLOATS + 8 * c["tiles"] + 20 * c["pixels"])
    bwd = seconds(PAIR_BACKWARD[0] * c["applied"], PAIR_BACKWARD[1] * c["applied"],
                  c["entries"] * (4 * ROW_FLOATS + 4) + 8 * c["tiles"] + 20 * c["pixels"]
                  + c["visible"] * 4 * ROW_FLOATS)
    return fwd + bwd


def preprocess_adam(c: dict) -> float:
    live, vis = c["live"], c["visible"]
    fwd = live * 4 * PARAM_FLOATS + vis * 4 * ROW_FLOATS + live * 8
    bwd = vis * (4 * ROW_FLOATS + 4 * PARAM_FLOATS) + vis * 4 * PARAM_FLOATS
    adam = vis * 4 * PARAM_FLOATS * 7
    return seconds(nbytes=fwd) + seconds(nbytes=bwd) + seconds(nbytes=adam)


def binning(c: dict) -> float:
    return seconds(nbytes=c["live"] * 33 + c["entries"] * (4 + 4 * ROW_FLOATS)
                   + 8 * c["tiles"])


def loss(c: dict) -> float:
    n = 3 * c["pixels"]
    return seconds(SSIM_FP32 * n, SSIM_MUFU * n, n * (4 + 1 + 4))


def step(c: dict) -> dict:
    """Seconds of each stage's bound and of the whole step's."""
    out = dict(blend=blend(c), preprocess_adam=preprocess_adam(c), binning=binning(c),
               loss=loss(c))
    out["step"] = sum(out.values())
    return out
