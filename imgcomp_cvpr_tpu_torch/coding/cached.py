"""Activation-cached scan codec (port of imgcomp_cvpr_tpu/coding/cached.py;
the schedule's arrays are the JAX package's, element for element).

The direct scan (coding/scan_codec.py) recomputes the whole 4-layer context
model on a (5, 9, 9) patch for every symbol. This schedule keeps one
activation cache per conv layer and, per wavefront step, computes each layer
only at the cells that just became computable: a cell is computed at step
(max step of the latent cells in its causal input cone) + 1, always before
its first unmasked use (a reader's cone is a superset, so readers come
later; reads within a step are ordered by layer). Per step and layer: gather
the (M_l, unmasked taps) input windows, one layer_sum, scatter M_l rows.

Cache cells whose cone holds no latent cell are functions of the padding
alone; they are set once per shape by running the four layers over the
all-pad volume (cells with t' < 0 as their all-pad constant), so every cell
holds the value it has in the direct scan and in kernel 2. The skip reads
of not-yet-written cells the JAX scan makes through zero weights are masked
taps here, which are never read. K=3 only.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_kernel as ck
from . import scan_codec
from . import wavefront

# (2, 3, 3) kernel window offsets in row-major (dz, dy, dx) order — the same
# order as a reshape of the (kd, k, k, ...) weight tensors.
_WINDOW = [(dz, dy, dx) for dz in range(2) for dy in range(3) for dx in range(3)]


def _unmasked_offsets(first: bool) -> List[int]:
    return [_WINDOW.index(tap) for tap in scan_codec.unmasked_taps(3, first)]


class LayerSchedule(NamedTuple):
    M: int
    out_idx: np.ndarray    # (T, M) int32 flat idx into this layer's cache (P_l sentinel = drop)
    in_base: np.ndarray    # (T, M) int32 flat idx of window origin in prev layer's grid
    active: np.ndarray     # (T, M) bool
    skip_idx: np.ndarray   # (T, M) int32 or None-like (for the residual skip)


class CachedSchedule(NamedTuple):
    base: wavefront.Schedule           # latent (layer-4 / rANS) schedule
    grids: Tuple[Tuple[int, int, int], ...]   # G0..G3 shapes
    layer_scheds: Tuple[LayerSchedule, ...]   # layers 1..3
    l4_in_base: np.ndarray             # (T, M) into G3
    offs: Tuple[np.ndarray, ...]       # window offsets per source grid G0..G3


def _flat(shape: Tuple[int, int, int], d, h, w):
    return ((d * shape[1]) + h) * shape[2] + w


def _window_offsets(shape: Tuple[int, int, int]) -> np.ndarray:
    return np.asarray([_flat(shape, dz, dy, dx) for dz, dy, dx in _WINDOW],
                      np.int32)


def _cone_max_step(prev: np.ndarray, unmasked: List[int]) -> np.ndarray:
    """prev: (D, Hh, Ww) max-step grid -> VALID-shrunk (D-1, Hh-2, Ww-2)."""
    d, hh, ww = prev.shape
    out = np.full((d - 1, hh - 2, ww - 2), -1, np.int64)
    for o in unmasked:
        dz, dy, dx = _WINDOW[o]
        np.maximum(out, prev[dz:dz + d - 1, dy:dy + hh - 2, dx:dx + ww - 2],
                   out=out)
    return out


def _group_by_step(steps: np.ndarray, T: int) -> Tuple[int, np.ndarray, np.ndarray]:
    """steps: (P,) flat per-position step (-1 = unscheduled). Returns
    (M, pos_idx (T, M) int32 with -1 pad, active (T, M))."""
    scheduled = np.nonzero(steps.ravel() >= 0)[0]
    s = steps.ravel()[scheduled]
    counts = np.bincount(s, minlength=T)
    M = int(counts.max()) if len(s) else 1
    order = np.argsort(s, kind='stable')
    pos_idx = np.full((T, M), -1, np.int64)
    start = np.concatenate([[0], np.cumsum(counts)])
    src = scheduled[order]
    for t in range(T):
        lo, hi = start[t], start[t + 1]
        pos_idx[t, :hi - lo] = src[lo:hi]
    return M, pos_idx, pos_idx >= 0


@functools.lru_cache(maxsize=8)
def build_cached_schedule(latent_shape: Tuple[int, int, int],
                          context_size: int = 9) -> CachedSchedule:
    assert context_size == 9, 'cached codec supports kernel_size=3 geometry'
    # The cone DP below uses the linear assignment for G0 steps; keep the
    # lane schedule consistent with it.
    base = wavefront.build_schedule(latent_shape, context_size, 'linear')
    C, H, W = latent_shape
    p = context_size // 2
    g0_shape = base.padded_shape

    # Max-step grids (the "causal cone" DP).
    t_lat = wavefront.linear_step_assignment(latent_shape, context_size)
    g0 = np.full(g0_shape, -1, np.int64)
    g0[p:, p:-p, p:-p] = t_lat

    first_um = _unmasked_offsets(first=True)
    other_um = _unmasked_offsets(first=False)
    m1 = _cone_max_step(g0, first_um)
    m2 = _cone_max_step(m1, other_um)
    m3 = _cone_max_step(m2, other_um)
    grids = (g0_shape, m1.shape, m2.shape, m3.shape)

    T = base.T
    layer_scheds = []
    for li, (m_grid, src_shape, dst_shape) in enumerate(
            [(m1, g0_shape, m1.shape), (m2, m1.shape, m2.shape),
             (m3, m2.shape, m3.shape)]):
        steps = np.where(m_grid >= 0, m_grid + 1, -1)
        # Positions whose cone peaks at the final step are never read by any
        # later logits computation — skip them entirely.
        steps = np.where(steps < T, steps, -1)
        M, pos_idx, active = _group_by_step(steps, T)
        dst_size = int(np.prod(dst_shape))
        d, h, w = np.unravel_index(np.where(pos_idx >= 0, pos_idx, 0), dst_shape)
        out_idx = np.where(active, pos_idx, dst_size).astype(np.int32)
        in_base = _flat(src_shape, d, h, w).astype(np.int32)
        in_base = np.where(active, in_base, 0).astype(np.int32)
        if li == 2:  # residual skip: L3[o] += L1[o + (2,2,2)]
            skip = _flat(grids[1], d + 2, h + 2, w + 2).astype(np.int32)
            skip = np.where(active, skip, 0).astype(np.int32)
        else:
            skip = np.zeros_like(in_base)
        layer_scheds.append(LayerSchedule(M=M, out_idx=out_idx, in_base=in_base,
                                          active=active, skip_idx=skip))

    # Layer 4 uses the latent schedule's lane ordering directly.
    pos = base.positions  # (T, M, 3) with -1 pads
    d = np.where(base.active, pos[..., 0], 0)
    h = np.where(base.active, pos[..., 1], 0)
    w = np.where(base.active, pos[..., 2], 0)
    l4_in_base = _flat(m3.shape, d, h, w).astype(np.int32)

    offs = tuple(_window_offsets(g) for g in grids)
    return CachedSchedule(base=base, grids=grids,
                          layer_scheds=tuple(layer_scheds),
                          l4_in_base=l4_in_base, offs=offs)




# ---------------------------------------------------------------------------


class CachedScanBuilder:
    """Builds the cached scan of a K=3 context model."""

    def __init__(self, pc_config):
        if pc_config.kernel_size != 3:
            raise ValueError('the cached scan is specialized to kernel_size 3')

    def make_run(self, latent_shape: Tuple[int, int, int]) -> scan_codec.ScanRun:
        cs = build_cached_schedule(tuple(latent_shape))
        sched = cs.base
        grids = cs.grids
        sizes = [int(np.prod(g)) for g in grids]
        first_um, other_um = _unmasked_offsets(True), _unmasked_offsets(False)

        def init(sw: scan_codec.ScanWeights, B: int):
            dev = sw.centers.device

            def t(a):
                return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

            st = {'sw': sw, 'tabs': scan_codec._sched_tables(sched, str(dev))}
            for li, ls in enumerate(cs.layer_scheds, 1):
                st[f'out{li}'] = t(ls.out_idx)
                st[f'base{li}'] = t(ls.in_base)
            st['skip3'] = t(cs.layer_scheds[2].skip_idx)
            st['base4'] = t(cs.l4_in_base)
            st['offs'] = (t(cs.offs[0][first_um]),) + tuple(t(o[other_um]) for o in cs.offs[1:])
            st['vol'] = torch.full((B, sizes[0] + 1), sw.pad, dtype=torch.float32, device=dev)
            # one spare row each: the drop slot of the scatters
            st['c'] = [None] + [torch.cat([c, c.new_zeros(1, c.shape[-1])])[None].repeat(B, 1, 1)
                                for c in _pad_caches(grids, sw)]
            return st

        def gather(cache, base, offs):
            g = cache[:, base[:, None] + offs[None, :]]           # (B, M_l, taps[, ch])
            return g.reshape(g.shape[0], g.shape[1], -1)

        def step_logits(st, t):
            sw, c = st['sw'], st['c']
            y1 = torch.relu(ck.layer_sum(
                gather(st['vol'], st['base1'][t], st['offs'][0]), sw.w[0], sw.b[0]))
            c[1][:, st['out1'][t]] = y1
            y2 = torch.relu(ck.layer_sum(
                gather(c[1], st['base2'][t], st['offs'][1]), sw.w[1], sw.b[1]))
            c[2][:, st['out2'][t]] = y2
            y3 = ck.layer_sum(
                gather(c[2], st['base3'][t], st['offs'][2]), sw.w[2], sw.b[2])
            c[3][:, st['out3'][t]] = y3 + c[1][:, st['skip3'][t]]
            return torch.relu(ck.layer_sum(
                gather(c[3], st['base4'][t], st['offs'][3]), sw.w[3], sw.b[3]))

        def write(st, t, sym):
            tabs = st['tabs']
            idx = torch.where(tabs.active[t], tabs.scatter_flat[t], sizes[0])
            st['vol'][:, idx] = st['sw'].centers[sym]

        return scan_codec.ScanRun(sched, init, step_logits, write)


def _pad_caches(grids, sw: scan_codec.ScanWeights):
    """The three layer caches (G1, G2, G3 grids, (cells, kf)) over the
    all-pad volume: each cell the layer sum of the layer below, a cell with
    t' = 25 d + 5 h + w - 31 (4 - l) < 0 (latent-aligned) its all-pad
    constant."""
    dev = sw.centers.device
    x = torch.full((int(np.prod(grids[0])), 1), sw.pad, dtype=torch.float32, device=dev)
    out = []
    for l in range(1, 4):
        D, H, W = grids[l]
        idx, _ = scan_codec.valid_taps(tuple(grids[l - 1]), 3, l == 1)
        y = scan_codec.masked_layer(x, l, sw, torch.from_numpy(idx).to(dev))
        if l == 3:     # the skip: the layer-1 cell at the same position
            y = y + out[0].reshape(D + 2, H + 4, W + 4, -1)[2:, 2:2 + H, 2:2 + W].reshape(y.shape)
        else:
            y = torch.relu(y)
        d, h, w = np.meshgrid(np.arange(D), np.arange(H), np.arange(W), indexing='ij')
        pre = torch.from_numpy((25 * d + 5 * h + w - 31 * (4 - l) < 0).reshape(-1)).to(dev)
        y = torch.where(pre[:, None], sw.k[l - 1], y)
        out.append(y)
        x = y
    return out
