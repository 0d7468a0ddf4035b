"""Ring-buffer scan codec (port of imgcomp_cvpr_tpu/coding/ring.py; the
RingSchedule's arrays are the JAX package's, element for element).

Index every cache cell by v = 25 d + 5 h + w (grid coordinates). Then

- layer l writes exactly one v-row a step: v_out = t + c_l with
  c_l = 31 * (4 - l) (each conv layer shifts the window centre by (1, 1, 1)
  in (d, h, w), 25 + 5 + 1 = 31 steps);
- that row's (2, 3, 3) causal window reads v-rows [v_out, v_out + 37] of the
  layer below, offsets [-31, +6] from its newest row; the unmasked taps
  reach offsets <= 0 only (already written), and the rows +1..+6 are read
  by masked taps alone, which are skipped here;
- within a v-row only the depths d with u = v - 25 d inside the grid hold
  cells, so a row is computed over a d-window (start precomputed per step),
  as a dense (DW, H) plane, and every tap is a static slice of the window.

Each cache is a ring of the most recent VR = 44 v-rows, stored twice (ring[i]
== ring[i + VR]), so any 38-row window is one contiguous slice. Per step and
layer: one slice of the ring, the unmasked taps' slices, one layer_sum over
the plane (the JAX scan's dense matmul), two windowed ring writes.

Pre-history rows (v < c_l, i.e. t' < 0) hold the all-pad constant of their
layer, as the rings start filled with it. Cells outside a row's d-window and
plane cells outside the grid are dead storage that valid cells never read
through an unmasked tap. K=3 only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_kernel as ck
from . import scan_codec
from . import wavefront

_WINDOW = [(dz, dy, dx) for dz in range(2) for dy in range(3) for dx in range(3)]
_OFFS = [25 * dz + 5 * dy + dx for dz, dy, dx in _WINDOW]
_SPAN = max(_OFFS) + 1          # 38: v-rows a window touches
VR = 44                          # ring rows (>= _SPAN + 6 junk rows)
_C = (124, 93, 62, 31, 0)        # v-row constant per level (q, L1..L4)


class RingSchedule(NamedTuple):
    base: wavefront.Schedule
    DW: Tuple[int, ...]        # d-window widths for (q-write, L1..L4 outputs)
    d_lo: Tuple[np.ndarray, ...]   # (T,) int32 window starts, same order
    skip_off: np.ndarray       # (T,) int32 d-offset of the L3 residual skip in y1
    lane_plane: np.ndarray     # (T, M) int32: lane -> window-rel (d*H + h) in logits
    lane_q: np.ndarray         # (T, M) int32: lane -> window-rel (d0*H0 + h0) in q row
    q_latent: np.ndarray       # (T, DW0, H0) bool: latent cells of the q-row window


def _u_max(shape: Tuple[int, int, int]) -> int:
    return 5 * (shape[1] - 1) + shape[2] - 1


@functools.lru_cache(maxsize=8)
def build_ring_schedule(latent_shape: Tuple[int, int, int],
                        context_size: int = 9) -> RingSchedule:
    assert context_size == 9, 'ring codec is specialized to kernel_size=3'
    # The v-row algebra requires the *linear* step assignment t = 25d+5h+w
    # (ASAP happens to coincide for this geometry, but don't depend on it).
    base = wavefront.build_schedule(latent_shape, context_size, 'linear')
    C, H, W = latent_shape
    p = context_size // 2
    g0 = base.padded_shape
    g1 = (g0[0] - 1, g0[1] - 2, g0[2] - 2)
    g2 = (g1[0] - 1, g1[1] - 2, g1[2] - 2)
    g3 = (g2[0] - 1, g2[1] - 2, g2[2] - 2)
    g4 = (C, H, W)
    out_grids = (g0, g1, g2, g3, g4)   # q row writes into g0
    T = base.T
    t_arr = np.arange(T)

    DW, d_lo = [], []
    for grid, c in zip(out_grids, _C):
        um = _u_max(grid)
        dw = min(-(-(um + 1) // 25), grid[0])
        lo = np.clip(-(-(t_arr + c - um) // 25), 0, grid[0] - dw).astype(np.int32)
        DW.append(dw)
        d_lo.append(lo)

    # L3's residual skip reads this step's y1 at absolute depth d3 + 2.
    # Widen y1's window so it always covers both its own valid rows and the
    # skip range [d_lo3 + 2, d_lo3 + 2 + DW3).
    lo1e_unc = np.minimum(d_lo[1], d_lo[3] + 2)
    top1e = np.maximum(d_lo[1] + DW[1], d_lo[3] + 2 + DW[3])
    dw1e = min(int((top1e - lo1e_unc).max()), g1[0])
    lo1e = np.clip(lo1e_unc, 0, g1[0] - dw1e).astype(np.int32)
    assert (lo1e <= lo1e_unc).all() and (lo1e + dw1e >= top1e).all()
    DW[1] = dw1e
    d_lo[1] = lo1e
    DW = tuple(DW)
    d_lo = tuple(d_lo)

    skip_off = (d_lo[3] + 2 - d_lo[1]).astype(np.int32)
    assert (skip_off >= 0).all()
    assert (skip_off + DW[3] <= DW[1]).all(), 'skip slice exceeds y1 window'

    # Lane mappings (window-relative).
    act = base.active
    pos = base.positions
    d4lo = d_lo[4]
    lane_plane = np.full((T, base.M), DW[4] * H, np.int32)
    lane_q = np.full((T, base.M), DW[0] * g0[1], np.int32)
    rel_d = pos[..., 0] - d4lo[:, None]
    lane_plane[act] = (rel_d[act] * H + pos[..., 1][act]).astype(np.int32)
    rel_d0 = pos[..., 0] + p - d_lo[0][:, None]
    lane_q[act] = (rel_d0[act] * g0[1] + pos[..., 1][act] + p).astype(np.int32)
    assert (rel_d[act] >= 0).all() and (rel_d[act] < DW[4]).all()
    assert (rel_d0[act] >= 0).all() and (rel_d0[act] < DW[0]).all()

    # Latent-cell mask of the q-row window: cell (d0 = d_lo0 + i, h0) with
    # w0 = (t + 124) - 25 d0 - 5 h0 is latent iff every padded coord minus p
    # is inside the latent grid.
    i_idx = np.arange(DW[0])[None, :, None]
    h0 = np.arange(g0[1])[None, None, :]
    d0_abs = d_lo[0][:, None, None] + i_idx
    w0 = t_arr[:, None, None] + _C[0] - 25 * d0_abs - 5 * h0
    q_latent = ((d0_abs >= p) & (d0_abs < p + C) & (h0 >= p) & (h0 < p + H)
                & (w0 >= p) & (w0 < p + W))
    return RingSchedule(base=base, DW=DW, d_lo=d_lo, skip_off=skip_off,
                        lane_plane=lane_plane, lane_q=lane_q, q_latent=q_latent)


class RingScanBuilder:
    """Builds the ring scan of a K=3 context model."""

    def __init__(self, pc_config):
        if pc_config.kernel_size != 3:
            raise ValueError('the ring scan is specialized to kernel_size 3')

    def make_run(self, latent_shape: Tuple[int, int, int]) -> scan_codec.ScanRun:
        rs = build_ring_schedule(tuple(latent_shape))
        sched = rs.base
        C, H, W = latent_shape
        D0, H0, _ = sched.padded_shape
        D1, H1 = D0 - 1, H0 - 2
        D2, H2 = D1 - 1, H1 - 2
        D3, H3 = D2 - 1, H2 - 2
        DW0, DW1, DW2, DW3, DW4 = rs.DW
        taps = (scan_codec.unmasked_taps(3, True), scan_codec.unmasked_taps(3, False))

        def init(sw: scan_codec.ScanWeights, B: int):
            dev = sw.centers.device
            kf = sw.k[0].shape[0]

            def t(a):
                return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

            def ring(dims, fill):
                return fill.reshape(1, 1, 1, 1, -1).expand(B, 2 * VR, *dims, kf).clone()

            return {
                'sw': sw, 'tabs': scan_codec._sched_tables(sched, str(dev)),
                'r0': torch.full((B, 2 * VR, D0, H0), sw.pad, dtype=torch.float32, device=dev),
                'r1': ring((D1, H1), sw.k[0]), 'r2': ring((D2, H2), sw.k[1]),
                'r3': ring((D3, H3), sw.k[2]),
                'lane_plane': t(np.minimum(rs.lane_plane, DW4 * H - 1)),
                'lane_q': t(rs.lane_q),
                'q_latent': torch.from_numpy(rs.q_latent).to(dev),
            }

        def ring_read(ring, hm, d_start, dw):
            """Rows [newest-31 .. newest+6] x the depth window as one slab."""
            start = (hm - 31) % VR
            d_start = min(d_start, ring.shape[2] - dw)
            return ring[:, start:start + _SPAN, d_start:d_start + dw]

        def ring_write(ring, hm, d_start, row):
            for base in (hm, hm + VR):
                ring[:, base, d_start:d_start + row.shape[1]] = row

        def plane(slab, l, d_out, h_out, sw):
            """slab (B, 38, d_out + 1, h_in[, ch]) -> (B, d_out, h_out, cout)."""
            if slab.dim() == 4:
                slab = slab[..., None]
            cols = [slab[:, 25 * dz + 5 * dy + dx, dz:dz + d_out, dy:dy + h_out]
                    for dz, dy, dx in taps[l > 1]]
            g = torch.stack(cols, 3)
            return ck.layer_sum(g.reshape(*g.shape[:3], -1), sw.w[l - 1], sw.b[l - 1])

        def step_logits(st, t):
            sw = st['sw']
            hm = t % VR
            lo = [int(rs.d_lo[i][t]) for i in range(5)]
            y1 = torch.relu(plane(ring_read(st['r0'], hm, lo[1], DW1 + 1), 1, DW1, H1, sw))
            ring_write(st['r1'], hm, lo[1], y1)
            y2 = torch.relu(plane(ring_read(st['r1'], hm, lo[2], DW2 + 1), 2, DW2, H2, sw))
            ring_write(st['r2'], hm, lo[2], y2)
            so = int(rs.skip_off[t])
            y3 = (plane(ring_read(st['r2'], hm, lo[3], DW3 + 1), 3, DW3, H3, sw)
                  + y1[:, so:so + DW3, 2:2 + H3])
            ring_write(st['r3'], hm, lo[3], y3)
            logits = torch.relu(plane(ring_read(st['r3'], hm, lo[4], DW4 + 1), 4, DW4, H, sw))
            return logits.reshape(logits.shape[0], -1, logits.shape[-1])[:, st['lane_plane'][t]]

        def write(st, t, sym):
            """The q row: latent cells of the window get their centers, every
            other cell (the real padding too) the pad value."""
            sw = st['sw']
            B = sym.shape[0]
            win = torch.zeros(B, DW0 * H0 + 1, dtype=torch.float32, device=sym.device)
            win[:, st['lane_q'][t]] = sw.centers[sym]
            q_row = torch.where(st['q_latent'][t], win[:, :-1].reshape(B, DW0, H0), sw.pad)
            ring_write(st['r0'], t % VR, int(rs.d_lo[0][t]), q_row)

        return scan_codec.ScanRun(sched, init, step_logits, write)
