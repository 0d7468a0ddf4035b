"""Planar (per-depth-plane) wavefront schedule for any kernel_size (own copy
of the byte-fixing part of imgcomp_cvpr_tpu/coding/planar.py).

Depth decomposition: only the top depth slice of a masked conv3d kernel is
causally masked, so when symbol plane d is coded every lower plane is known.
Each layer's contribution from its lower slices is an ordinary 2D VALID conv
over known planes (the "bias rows", computed before the plane); only the
top slice is autoregressive, and it reaches only within the current plane.
Coding runs C rounds of: bias rows for plane d, then a 2D wavefront over
the plane (kernel 5, coding/planar_kernel.py).

Wavefront geometry, in each level's own grid coordinates. Level 0 is the
padded q plane (H + 2 reach, W + 2 reach), level l = 1..4 is layer l's output
grid (level 4 is the latent plane). With BH = reach + 1 and CTR = BH (K//2)
+ K//2, cell (h, w) of level l is computed at step t = BH h + w + CTR l; a
top-slice tap (dy, dx) reads level l-1 cell (h + dy, w + dx), written at step
t - CTR + BH dy + dx <= t (equality only for the centre tap of layers 2-4,
computed earlier in the same step). Layer 3's residual skip (level-1 cell
(h + K-1, w + K-1)) and the q write of a coded symbol land in the same step
as the cell that needs them.

What fixes the bytes is kept exactly: the step -> band map v4 = t - 4 CTR
with lane r = band cell h_lo + r (``idx_cm``), the active mask, R = 32 rANS
lanes with one chunk per step, and the (plane, step) coding order. The TPU
layout (absolute-h lanes, VR-slot rings, sublane replication, lane rolls,
step blocks padded to K_STEPS) is Mosaic's and is not carried over.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np

from ..models.probclass import spatial_mask

NUM_LAYERS = 4    # conv0 + 2 residual convs + conv_out
R = 32            # rANS lanes, one chunk per step


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def geometry(K: int) -> Tuple[int, int, int, int]:
    """(kd, reach, BH, CTR)."""
    kd = K // 2 + 1
    reach = NUM_LAYERS * (K // 2)
    BH = reach + 1
    CTR = BH * (K // 2) + K // 2
    return kd, reach, BH, CTR


def grids_2d(latent_hw: Tuple[int, int], K: int):
    """2D grid (H, W) per level 0..4 (level 0 = padded plane, 4 = latent)."""
    H, W = latent_hw
    _, reach, _, _ = geometry(K)
    g = [(H + 2 * reach, W + 2 * reach)]
    for _ in range(NUM_LAYERS):
        g.append((g[-1][0] - (K - 1), g[-1][1] - (K - 1)))
    assert g[-1] == (H, W), (g, latent_hw)
    return tuple(g)


def unmasked_taps(K: int, first: bool) -> Tuple[Tuple[int, int], ...]:
    """Top-slice taps with nonzero causal mask, as (dy, dx)."""
    m = spatial_mask(K, first)
    return tuple((dy, dx) for dy in range(K) for dx in range(K) if m[dy, dx] > 0)


class PlanarSchedule(NamedTuple):
    latent_shape: Tuple[int, int, int]   # (C, H, W)
    K: int
    BH: int
    CTR: int
    T2: int                              # wavefront steps per plane
    grids: Tuple[Tuple[int, int], ...]   # levels 0..4
    taps: Tuple[Tuple[Tuple[int, int], ...], ...]  # per layer 1..4
    h_lo: np.ndarray                     # (T2,) level-4 band start h
    n_band: int                          # max band cells (level 4)
    table: np.ndarray                    # (T2, 1, 2): [h_lo, step has a symbol]
    active_cm: np.ndarray                # (T2, 1, R) int32 band mask
    idx_cm: np.ndarray                   # (T2, R) -> h*W + w (or H*W if dead)
    wcap: int                            # full-image stream word capacity
    stream_cap: int                      # word capacity of one image's buffer


@functools.lru_cache(maxsize=8)
def build_planar_schedule(latent_shape: Tuple[int, int, int],
                          K: int) -> PlanarSchedule:
    latent_shape = tuple(int(v) for v in latent_shape)
    C, H, W = latent_shape
    kd, reach, BH, CTR = geometry(K)
    grids = grids_2d((H, W), K)
    assert (K - 1) * (BH + 1) == 2 * CTR
    assert reach * (BH + 1) == NUM_LAYERS * CTR

    # Level l writes row v_l = t - CTR*l; every level must cover its grid.
    T2 = 1 + max(BH * (g[0] - 1) + (g[1] - 1) + CTR * l
                 for l, g in enumerate(grids))
    t_arr = np.arange(T2)
    taps = tuple(unmasked_taps(K, first=(li == 1))
                 for li in range(1, NUM_LAYERS + 1))
    for tp in taps:   # taps read only rows written earlier (or this step)
        assert max(BH * dy + dx for dy, dx in tp) <= CTR, (K, tp)

    # Level-4 band of step t: v4 = t - 4*CTR; cells (h, w = v4 - BH*h).
    v4 = t_arr - NUM_LAYERS * CTR
    h_lo = np.clip(-(-(v4 - (W - 1)) // BH), 0, max(H - 1, 0))
    h_hi = np.minimum(H - 1, np.floor_divide(np.maximum(v4, 0), BH))
    n_band = int(np.max(np.where(v4 >= 0, h_hi - h_lo + 1, 0)))
    assert n_band <= R, (n_band, R, 'band exceeds one rANS chunk; '
                         'unsupported latent height/width ratio')

    r_idx = np.arange(R)
    h = h_lo[:, None] + r_idx[None, :]
    w = v4[:, None] - BH * h
    valid = ((v4[:, None] >= 0) & (r_idx[None, :] <= (h_hi - h_lo)[:, None])
             & (h >= 0) & (h < H) & (w >= 0) & (w < W))
    HW = H * W
    assert int(valid.sum()) == HW, (int(valid.sum()), HW)
    idx_cm = np.where(valid, h * W + np.maximum(w, 0), HW).astype(np.int32)

    table = np.zeros((T2, 1, 2), np.int32)
    table[:, 0, 0] = h_lo
    table[:, 0, 1] = valid.any(axis=1)

    wcap = _round_up(C * H * W + 2 * R, 128)
    return PlanarSchedule(
        latent_shape=latent_shape, K=K, BH=BH, CTR=CTR, T2=T2, grids=grids,
        taps=taps, h_lo=h_lo.astype(np.int32), n_band=n_band, table=table,
        active_cm=valid[:, None, :].astype(np.int32), idx_cm=idx_cm, wcap=wcap,
        stream_cap=(wcap // 128 + 2) * 128)


def plane_totals(sched: PlanarSchedule) -> np.ndarray:
    """(R,) int32 active symbols per rANS lane in ONE plane (the active mask
    is the same for every plane, so a lane's total is C times this)."""
    return sched.active_cm[:, 0, :].sum(axis=0).astype(np.int32)
