"""Wavefront schedule over the latent (C, H, W) symbol volume (port of
imgcomp_cvpr_tpu/coding/wavefront.py; its integer arrays are the JAX
package's, element for element).

The context model's receptive field is causal in (d, h, w)-raster order with
spatial reach p = context_size // 2. Each position gets a step t: the linear
assignment t = a*d + b*h + c*w with c = 1, b = p + 1, a = (p + 1)^2, or the
ASAP assignment t = 1 + max t(dependencies), which is the same for
kernel_size 3 and shorter for larger kernels. Every dependency has a smaller
t, so all positions of one step are conditionally independent and are coded
together. The schedule maps each step to its (padded, fixed-width M) list of
positions, with the gather / scatter indices of the XLA-style scans
(coding/scan_codec.py, coding/cached.py, coding/ring.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np


class Schedule(NamedTuple):
    T: int                      # number of wavefront steps
    M: int                      # max positions per step (lane count)
    pad: int                    # context pad (= context_size // 2)
    latent_shape: Tuple[int, int, int]   # (C, H, W)
    padded_shape: Tuple[int, int, int]   # (C+pad, H+2p, W+2p)
    active: np.ndarray          # (T, M) bool
    base_flat: np.ndarray       # (T, M) int32: flat idx of context-window origin
    scatter_flat: np.ndarray    # (T, M) int32: flat idx of the position itself
    sym_flat: np.ndarray        # (T, M) int32: flat idx into the (C,H,W) symbols
    ctx_offsets: np.ndarray     # (ctx_d*ctx_s*ctx_s,) int32 window offsets
    positions: np.ndarray       # (T, M, 3) int32 (d, h, w), -1 where inactive


def wavefront_coeffs(pad: int) -> Tuple[int, int, int]:
    b = pad + 1
    a = (pad + 1) ** 2
    return a, b, 1


def linear_step_assignment(latent_shape: Tuple[int, int, int],
                           context_size: int) -> np.ndarray:
    """t = a*d + b*h + c*w — simple, provably causal, but pessimistic (the
    depth coefficient a=(p+1)^2 pays for worst-case spatial offsets)."""
    C, H, W = latent_shape
    a, b, c = wavefront_coeffs(context_size // 2)
    d_idx, h_idx, w_idx = np.meshgrid(np.arange(C), np.arange(H), np.arange(W),
                                      indexing='ij')
    return a * d_idx + b * h_idx + c * w_idx


def asap_step_assignment(latent_shape: Tuple[int, int, int],
                         context_size: int) -> np.ndarray:
    """DAG-level ASAP schedule: t(p) = 1 + max t(deps), deps = causally
    earlier positions inside the receptive-field window. This is the true
    critical path (~2x fewer steps than the linear wavefront for CVPR
    geometry: rows of successive depth slices pipeline with lag ~p+1
    instead of (p+1)^2).

    Vectorized per depth slice:
      A(h, w) = max over last ctx_d-1 depth slices, full (2p+1)^2 window
      B(h, w) = max over rows h-p..h-1 of this slice, cols w-p..w+p
      within-row: t(w) = max(base(w), t(w-1) + 1)
                = w + runmax_{k<=w}(base(k) - k).
    """
    from scipy.ndimage import maximum_filter1d
    C, H, W = latent_shape
    p = context_size // 2
    depth_reach = context_size // 2  # previous depth slices in the context
    t = np.full((C, H, W), -1, np.int64)
    NEG = -(1 << 40)
    for d in range(C):
        if d == 0:
            A = np.full((H, W), NEG, np.int64)
        else:
            lo = max(0, d - depth_reach)
            m4 = t[lo:d].max(axis=0)
            # (2p+1)x(2p+1) max filter, border-clipped
            a1 = maximum_filter1d(m4, size=2 * p + 1, axis=0, mode='constant',
                                  cval=NEG)
            A = maximum_filter1d(a1, size=2 * p + 1, axis=1, mode='constant',
                                 cval=NEG)
        rows = np.full((p, W), NEG, np.int64)  # last p rows of this slice
        for h in range(H):
            B = maximum_filter1d(rows.max(axis=0), size=2 * p + 1,
                                 mode='constant', cval=NEG)
            base = 1 + np.maximum(A[h], B)
            base = np.maximum(base, 0)  # positions with no deps -> step 0
            shifted = base - np.arange(W)
            t[d, h] = np.arange(W) + np.maximum.accumulate(shifted)
            rows = np.roll(rows, -1, axis=0)
            rows[-1] = t[d, h]
    return t


@functools.lru_cache(maxsize=16)
def build_schedule(latent_shape: Tuple[int, int, int], context_size: int,
                   mode: str = 'asap') -> Schedule:
    C, H, W = latent_shape
    pad = context_size // 2

    if mode == 'asap':
        t_all = asap_step_assignment(latent_shape, context_size)
    else:
        t_all = linear_step_assignment(latent_shape, context_size)
    d_idx, h_idx, w_idx = np.meshgrid(np.arange(C), np.arange(H), np.arange(W),
                                      indexing='ij')
    T = int(t_all.max()) + 1
    counts = np.bincount(t_all.ravel(), minlength=T)
    M = int(counts.max())
    # Pad lane count to a multiple of the interleaved-rANS lane width so
    # per-step position blocks slice evenly into sub-iterations.
    if M > 64:
        M = -(-M // 64) * 64

    order = np.argsort(t_all.ravel(), kind='stable')
    d_s = d_idx.ravel()[order]
    h_s = h_idx.ravel()[order]
    w_s = w_idx.ravel()[order]
    t_s = t_all.ravel()[order]

    positions = np.full((T, M, 3), -1, np.int32)
    slot_of = np.zeros(len(order), np.int64)
    start = np.concatenate([[0], np.cumsum(counts)])
    for t in range(T):
        lo, hi = start[t], start[t + 1]
        n = hi - lo
        positions[t, :n, 0] = d_s[lo:hi]
        positions[t, :n, 1] = h_s[lo:hi]
        positions[t, :n, 2] = w_s[lo:hi]
    active = positions[..., 0] >= 0

    Cp, Hp, Wp = C + pad, H + 2 * pad, W + 2 * pad
    dp = positions[..., 0] + pad
    hp = positions[..., 1] + pad
    wp = positions[..., 2] + pad

    def flat_padded(d, h, w):
        return ((d * Hp) + h) * Wp + w

    # context window origin: (dp - (ctx_d-1), hp - pad, wp - pad)
    ctx_d = context_size // 2 + 1
    base_flat = flat_padded(dp - (ctx_d - 1), hp - pad, wp - pad).astype(np.int32)
    scatter_flat = flat_padded(dp, hp, wp).astype(np.int32)
    total = Cp * Hp * Wp
    base_flat = np.where(active, base_flat, 0).astype(np.int32)
    scatter_flat = np.where(active, scatter_flat, total).astype(np.int32)  # drop

    sym_flat = ((positions[..., 0] * H + positions[..., 1]) * W + positions[..., 2])
    sym_flat = np.where(active, sym_flat, 0).astype(np.int32)

    dd, hh, ww = np.meshgrid(np.arange(ctx_d), np.arange(context_size),
                             np.arange(context_size), indexing='ij')
    ctx_offsets = flat_padded(dd, hh, ww).ravel().astype(np.int32)

    return Schedule(T=T, M=M, pad=pad, latent_shape=(C, H, W),
                    padded_shape=(Cp, Hp, Wp), active=active,
                    base_flat=base_flat, scatter_flat=scatter_flat,
                    sym_flat=sym_flat, ctx_offsets=ctx_offsets,
                    positions=positions)


def check_schedule_causality(sched: Schedule, context_size: int) -> None:
    """Verify: no position's causal context contains a position of the same
    or a later step (property test helper)."""
    C, H, W = sched.latent_shape
    step_of = {}
    for t in range(sched.T):
        for j in range(sched.M):
            if sched.active[t, j]:
                d, h, w = sched.positions[t, j]
                step_of[(d, h, w)] = t
    p = context_size // 2
    for (d, h, w), t in step_of.items():
        # causal deps: earlier raster positions within the receptive field
        # (depth window: current + p previous slices; spatial: +-p)
        for dd in range(max(0, d - p), d + 1):
            for hh in range(max(0, h - p), min(H, h + p + 1)):
                for ww in range(max(0, w - p), min(W, w + p + 1)):
                    if (dd, hh, ww) == (d, h, w):
                        continue
                    before = (dd < d or (dd == d and (hh < h or (hh == h and ww < w))))
                    if not before:
                        continue
                    dep_t = step_of.get((dd, hh, ww))
                    if dep_t is not None:
                        assert dep_t < t, ((dd, hh, ww), (d, h, w))
