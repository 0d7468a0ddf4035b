"""K=3 wavefront codec kernels for the H100: schedule, CUDA kernels 2 and 3,
and their plain PyTorch versions.

Counterpart of imgcomp_cvpr_tpu/coding/pallas_kernel.py. What fixes the
bytes is kept exactly: the linear wavefront schedule t = 25d + 5h + w, the
R = 32 persistent rANS lanes, the row-anchored chunk-major sub-iteration
layout (``idx_cm``: which latent cell sits in which (step, sub-iteration,
lane)), the descending-rank word emission order and x0 = 1 tail packing.
The TPU layout (transposed band rings, lane rolls, one-hot word moves) is
not carried over.

Geometry, in latent-aligned coordinates. Layer l = 1..4 of the context
model owns a grid of cells (d, h, w) with d in [-(4-l), C-1], h in
[-(4-l), H-1+(4-l)], w in [-(4-l), W-1+(4-l)] (layer 4 is the latent grid,
layer 1 is (C+3) x (H+6) x (W+6)). Cell (d, h, w) is computed at step
t' = 25d + 5h + w; tap (dz, dy, dx) of its (2, 3, 3) window reads cell
(d+dz-1, h+dy-1, w+dx-1) of the layer below, whose step is strictly
earlier except for the centre tap of layers 2-4 (same step, computed by
the previous layer phase). A cell with t' < 0 sees only padding, so it
holds the all-pad activation constant; a q cell outside the latent holds
the pad value. The host precomputes, per layer, the cells of every step
(``ptr``/``cells``) and every cell's source index per unmasked tap
(``taps``): a source of row G (one past the grid) is the constant row.

Kernel 2 (csrc/wavefront_forward.cu, one block per image) runs the steps
in order: layer 1..4 cells of step t, then the step's rANS lanes; mode 1
(encode) reads teacher symbols and writes per-symbol (freq, start), mode 0
(decode) runs the sequential 32-lane interleaved rANS decode. Both modes
compute logits and CDFs with the same code. Kernel 3 (csrc/rans_reverse.cu,
one warp per image) is the reverse interleaved rANS encoder.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.probclass import spatial_mask
from ..ops.kernels import build
from . import rans

_WINDOW = [(dz, dy, dx) for dz in range(2) for dy in range(3) for dx in range(3)]
R = 32                    # persistent rANS lanes of the wavefront codec
MAX_L = 16                # CDF tables per lane live in registers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _unmasked_taps(first: bool):
    """Window indices (dz*9 + dy*3 + dx) whose masked weight is not all
    zero: 13 for the first layer, 14 for the others."""
    m = spatial_mask(3, first)
    return [o for o, (dz, dy, dx) in enumerate(_WINDOW)
            if dz == 0 or m[dy, dx] > 0]


# ---------------------------------------------------------------------------
# Schedule (own copy of the byte-fixing part of build_pallas_schedule)
# ---------------------------------------------------------------------------

_C = (124, 93, 62, 31, 0)   # v-row constant per level (q, L1..L4)


def _row_maps(grid):
    d_grid, h_grid, w_grid = grid
    u_max = 5 * (h_grid - 1) + w_grid - 1

    def j0(v):
        return np.maximum(0, -(-(v - (w_grid - 1)) // 5))

    def d_lo(v):
        return np.clip(-(-(v - u_max) // 25), 0, d_grid - 1)

    return j0, d_lo


def _grids(latent_shape, p=4):
    C, H, W = latent_shape
    g0 = (C + p, H + 2 * p, W + 2 * p)
    g1 = (g0[0] - 1, g0[1] - 2, g0[2] - 2)
    g2 = (g1[0] - 1, g1[1] - 2, g1[2] - 2)
    g3 = (g2[0] - 1, g2[1] - 2, g2[2] - 2)
    return (g0, g1, g2, g3, (C, H, W))


class LayerCells(NamedTuple):
    G: int                 # cells in the layer's grid (row G = constant)
    ptr: np.ndarray        # (T+1,) int32: cells of step t are cells[ptr[t]:ptr[t+1]]
    cells: np.ndarray      # (N,) int32 flat grid index, sorted by step
    taps: np.ndarray       # (N, ntaps) int32 source row in the layer below


class Schedule(NamedTuple):
    latent_shape: Tuple[int, int, int]
    T: int                         # wavefront steps
    S: int                         # rANS sub-iterations per step
    CQ: int                        # chunk-major row width (multiple of 128)
    chunk_offs: Tuple[int, ...]    # plane offsets of the sub-iterations
    idx_cm: np.ndarray             # (T, CQ) int32 -> flat latent idx, n if dead
    stream_cap: int                # word capacity of one image's stream
    layers: Tuple[LayerCells, ...]  # layers 1..4
    skip: np.ndarray               # (N3,) int32 layer-1 row of each L3 cell


def _layer_cells(latent_shape, l: int, T: int):
    C, H, W = latent_shape
    o = 4 - l
    Dg, Hg, Wg = C + o, H + 2 * o, W + 2 * o
    d = np.arange(Dg)[:, None, None] - o
    h = np.arange(Hg)[None, :, None] - o
    w = np.arange(Wg)[None, None, :] - o
    t = (25 * d + 5 * h + w).reshape(-1)
    gi = np.nonzero((t >= 0) & (t < T))[0]
    gi = gi[np.argsort(t[gi], kind='stable')]
    ts = t[gi]
    ptr = np.searchsorted(ts, np.arange(T + 1)).astype(np.int32)
    dd = gi // (Hg * Wg) - o
    hh = (gi // Wg) % Hg - o
    ww = gi % Wg - o
    taps = []
    for tap in _unmasked_taps(first=(l == 1)):
        dz, dy, dx = _WINDOW[tap]
        di, hi, wi = dd + dz - 1, hh + dy - 1, ww + dx - 1
        if l == 1:   # q volume: latent cells, else the pad value (row n)
            latent = ((di >= 0) & (di < C) & (hi >= 0) & (hi < H)
                      & (wi >= 0) & (wi < W))
            src = np.where(latent, (di * H + hi) * W + wi, C * H * W)
        else:
            op = o + 1
            Hp, Wp = H + 2 * op, W + 2 * op
            assert (di >= -op).all() and (hi >= -op).all() and (wi >= -op).all()
            assert (hi < H + op).all() and (wi < W + op).all()
            tin = 25 * di + 5 * hi + wi
            src = np.where(tin >= 0, ((di + op) * Hp + (hi + op)) * Wp + (wi + op),
                           (C + op) * Hp * Wp)
        taps.append(src)
    cells = LayerCells(G=Dg * Hg * Wg, ptr=ptr, cells=gi.astype(np.int32),
                       taps=np.stack(taps, 1).astype(np.int32))
    skip = None
    if l == 3:       # residual skip: the layer-1 cell at the same (d, h, w)
        skip = (((dd + 3) * (H + 6) + (hh + 3)) * (W + 6) + (ww + 3)).astype(np.int32)
    return cells, skip


@functools.lru_cache(maxsize=8)
def build_schedule(latent_shape: Tuple[int, int, int]) -> Schedule:
    latent_shape = tuple(int(v) for v in latent_shape)
    C, H, W = latent_shape
    grids = _grids(latent_shape)
    T = 25 * (C - 1) + 5 * (H - 1) + (W - 1) + 1
    t_arr = np.arange(T)

    # Packed band extents per level: they fix the chunk layout below.
    DW, J = [], []
    for grid, c in zip(grids, _C):
        j0f, dlof = _row_maps(grid)
        d_grid, h_grid, w_grid = grid
        dw = jmax = 1
        v = t_arr[:, None] + c
        d_idx = np.arange(d_grid)[None, :]
        u = v - 25 * d_idx
        ok = (u >= 0) & (u <= 5 * (h_grid - 1) + w_grid - 1)
        if ok.any():
            rel_d = d_idx - dlof(v)
            h_hi = np.minimum(h_grid - 1, np.maximum(u, 0) // 5)
            jj = h_hi + 5 * d_idx - j0f(v)
            dw = int(rel_d[ok].max()) + 1
            jmax = int(jj[ok].max()) + 1
        DW.append(dw)
        J.append(jmax)
    J_STORE = max(J)
    P_pad = _round_up(max(DW[4] * J_STORE, 128), 128)

    # Logits-plane lane -> latent cell of each step.
    j0_4, dlo_4 = _row_maps(grids[4])
    m = np.arange(P_pad)
    rel_d = m // J_STORE
    jj = m % J_STORE
    d = dlo_4(t_arr)[:, None] + rel_d[None, :]
    h = jj[None, :] + j0_4(t_arr)[:, None] - 5 * d
    w = t_arr[:, None] - 25 * d - 5 * h
    valid = ((rel_d < DW[4])[None, :] & (jj < J[4])[None, :]
             & (d >= 0) & (d < C) & (h >= 0) & (h < H) & (w >= 0) & (w < W))
    n = C * H * W
    idx_map = np.where(valid, (d * H + np.maximum(h, 0)) * W + np.maximum(w, 0), n)
    assert int(valid.sum()) == n
    assert (np.sort(idx_map[valid]) == np.arange(n)).all(), 'not a permutation'

    # Row-anchored R-wide chunks (sequential coverage for tiny strides).
    row_span = -(-J[4] // R) * R
    if row_span <= J_STORE and P_pad >= (DW[4] - 1) * J_STORE + row_span:
        chunk_offs = tuple(dd * J_STORE + c * R
                           for dd in range(DW[4]) for c in range(row_span // R))
    else:
        chunk_offs = tuple(range(0, P_pad, R))
    S = len(chunk_offs)
    cover = np.zeros(P_pad, np.int32)
    for off in chunk_offs:
        cover[off:off + R] += 1
    assert (cover <= 1).all(), 'overlapping rANS chunks'
    assert ((cover > 0) | ~valid.any(axis=0)).all(), 'chunks miss active lanes'

    CQ = _round_up(S * R, 128)
    cm_src = np.concatenate([np.arange(off, off + R) for off in chunk_offs])
    idx_cm = np.full((T, CQ), n, np.int32)
    idx_cm[:, :S * R] = idx_map[:, cm_src]

    wcap = _round_up(n + 2 * R, 128)
    layers, skip = [], None
    for l in range(1, 5):
        cells, sk = _layer_cells(latent_shape, l, T)
        layers.append(cells)
        skip = sk if sk is not None else skip
    assert (layers[3].cells[np.argsort(layers[3].cells)] == np.arange(n)).all()
    return Schedule(latent_shape=latent_shape, T=T, S=S, CQ=CQ,
                    chunk_offs=chunk_offs, idx_cm=idx_cm,
                    stream_cap=(wcap // 128 + 2) * 128,
                    layers=tuple(layers), skip=skip)


def lane_totals(sched: Schedule) -> np.ndarray:
    """(R,) int32 active symbols per persistent rANS lane: the base of the
    tail-packing pull threshold (total - k)."""
    act = sched.idx_cm[:, :sched.S * R] < int(np.prod(sched.latent_shape))
    return act.reshape(sched.T, sched.S, R).sum(axis=(0, 1)).astype(np.int32)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same bits."""
    x = x & rans.MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).int()


class DeviceTables(NamedTuple):
    ptr: Tuple[torch.Tensor, ...]     # per layer (T+1,) int32
    cells: Tuple[torch.Tensor, ...]   # per layer (N,) int32
    taps: Tuple[torch.Tensor, ...]    # per layer (N, ntaps) int32
    skip: torch.Tensor                # (N3,) int32
    idx_cm: torch.Tensor              # (T, CQ) int32


@functools.lru_cache(maxsize=8)
def device_tables(latent_shape: Tuple[int, int, int], device: str) -> DeviceTables:
    sched = build_schedule(latent_shape)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DeviceTables(ptr=tuple(t(c.ptr) for c in sched.layers),
                        cells=tuple(t(c.cells) for c in sched.layers),
                        taps=tuple(t(c.taps) for c in sched.layers),
                        skip=t(sched.skip), idx_cm=t(sched.idx_cm))


# ---------------------------------------------------------------------------
# Folded weights
# ---------------------------------------------------------------------------

class FoldedWeights(NamedTuple):
    """Context-model weights packed for the wavefront: unmasked taps only,
    each (ntaps, cin, cout) in window order; per-layer all-pad constants
    k1..k3 (kf,); the pad value (1,); the centers (L,). All float32."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    w4: torch.Tensor
    b4: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    pad: torch.Tensor
    centers: torch.Tensor

    def packed(self) -> torch.Tensor:
        return torch.cat([a.reshape(-1).float() for a in self]).contiguous()


# ---------------------------------------------------------------------------
# CDF quantization (plain twin of the kernels' shared __device__ function)
# ---------------------------------------------------------------------------

def logits_to_cdf(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) f32 logits -> (freq, cdf_low) int64: softmax with a
    sequential sum over L, then rans.quantize_cdf. The same order of
    operations as cdf_from_logits in csrc/wavefront_forward.cu."""
    m = logits.max(-1, keepdim=True).values
    e = torch.exp(logits - m)
    s = e[..., 0]
    for l in range(1, e.shape[-1]):
        s = s + e[..., l]
    return rans.quantize_cdf(e / s[..., None])


# ---------------------------------------------------------------------------
# Kernel 2: wavefront forward (encode / decode)
# ---------------------------------------------------------------------------

MODE_DECODE, MODE_ENCODE = 0, 1


def _layer_step(src: torch.Tensor, taps: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """src (B, G+1, cin), taps (nc, ntaps) -> (B, nc, cout) pre-activation,
    accumulated in the kernel's order: over (tap, input channel) one
    rounded multiply and one rounded add at a time, then the bias."""
    x = src[:, taps.long()]                                # (B, nc, ntaps, cin)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    wf = w.reshape(-1, w.shape[-1])
    acc = torch.zeros(x.shape[0], x.shape[1], wf.shape[1], dtype=x.dtype,
                      device=x.device)
    for j in range(wf.shape[0]):
        acc = acc + x[..., j, None] * wf[j]
    return acc + b


def wavefront_forward_plain(mode: int, weights: FoldedWeights,
                            latent_shape: Tuple[int, int, int], *,
                            true_syms=None, streams=None, init_states=None,
                            thresh=None, return_logits: bool = False):
    """Plain PyTorch version of kernel 2: a Python loop over the T steps,
    vectorised over the step's cells and the batch, with the kernel's layer
    and sub-iteration order.

    encode (mode 1): true_syms (B, n) int -> (freq_sel, start_sel) (B, T, CQ)
    int32 (0 on dead lanes). decode (mode 0): streams (B, W) int32 words,
    init_states (B, R) int64 (uint32 values), thresh (B, R) -> symbols (B, n)
    int32. ``return_logits`` also returns the (B, n, L) logits."""
    sched = build_schedule(latent_shape)
    dev = weights.w1.device
    tabs = device_tables(sched.latent_shape, str(dev))
    n = int(np.prod(sched.latent_shape))
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    B = (true_syms if mode == MODE_ENCODE else streams).shape[0]
    f32 = torch.float32
    q = torch.empty(B, n + 1, dtype=f32, device=dev)
    q[:, n] = weights.pad
    acts = []
    for li, k in enumerate((weights.k1, weights.k2, weights.k3)):
        a = torch.empty(B, sched.layers[li].G + 1, kf, dtype=f32, device=dev)
        a[:, -1] = k
        acts.append(a)
    logits = torch.empty(B, n, L, dtype=f32, device=dev)
    idx_cm = tabs.idx_cm.long()
    if mode == MODE_ENCODE:
        fsel = torch.zeros(B, sched.T, sched.CQ, dtype=torch.int32, device=dev)
        ssel = torch.zeros_like(fsel)
        true_l = true_syms.long()
    else:
        syms = torch.zeros(B, n, dtype=torch.int32, device=dev)
        states = init_states.long() & rans.MASK32
        gptr = torch.zeros(B, dtype=torch.long, device=dev)
        cnt = torch.zeros(B, R, dtype=torch.long, device=dev)
        thr = thresh.long()
        stream_l = streams.long()
    ptr = [c.ptr.tolist() for c in sched.layers]
    layer_w = ((weights.w1, weights.b1), (weights.w2, weights.b2),
               (weights.w3, weights.b3), (weights.w4, weights.b4))
    for t in range(sched.T):
        sl = [slice(p[t], p[t + 1]) for p in ptr]
        src = q[:, :, None]
        for li in range(4):
            cells = tabs.cells[li][sl[li]].long()
            y = _layer_step(src, tabs.taps[li][sl[li]], *layer_w[li])
            if li == 2:
                y = y + acts[0][:, tabs.skip[sl[2]].long()]
            else:
                y = torch.relu(y)
            if li < 3:
                acts[li][:, cells] = y
                src = acts[li]
            else:
                logits[:, cells] = y
        idx = idx_cm[t]                                    # (CQ,)
        act = idx < n
        idx_c = torch.clamp(idx, max=n - 1)
        fq, cl = logits_to_cdf(logits[:, idx_c])           # (B, CQ, L)
        if mode == MODE_ENCODE:
            sym = torch.where(act, true_l[:, idx_c], 0)
            fs = torch.gather(fq, -1, sym[..., None])[..., 0]
            ss = torch.gather(cl, -1, sym[..., None])[..., 0]
            fsel[:, t] = torch.where(act, fs, 0).int()
            ssel[:, t] = torch.where(act, ss, 0).int()
            live = idx[act]
            q[:, live] = weights.centers[sym[:, act]]
            continue
        for si in range(sched.S):
            lanes = slice(si * R, (si + 1) * R)
            a = act[lanes][None].expand(B, R)
            sym, states, gptr, cnt = rans.decode_step_interleaved(
                states, gptr, stream_l, fq[:, lanes], cl[:, lanes], a, cnt, thr)
            live = idx[lanes][act[lanes]]
            syms[:, live] = sym[:, act[lanes]].int()
            q[:, live] = weights.centers[sym[:, act[lanes]]]
    out = (fsel, ssel) if mode == MODE_ENCODE else syms
    return (out, logits) if return_logits else out


class _FwdArgs(ctypes.Structure):
    _fields_ = ([('mode', ctypes.c_int), ('B', ctypes.c_int), ('T', ctypes.c_int),
                 ('n', ctypes.c_int), ('kf', ctypes.c_int), ('L', ctypes.c_int),
                 ('CQ', ctypes.c_int), ('cap', ctypes.c_int),
                 ('G1', ctypes.c_int), ('G2', ctypes.c_int), ('G3', ctypes.c_int),
                 ('params', ctypes.c_void_p)]
                + [(f'{k}{l}', ctypes.c_void_p) for l in range(1, 5)
                   for k in ('ptr', 'cells', 'taps')]
                + [(k, ctypes.c_void_p) for k in (
                    'skip3', 'idx_cm', 'act1', 'act2', 'act3', 'logits', 'qbuf',
                    'true_syms', 'fsel', 'ssel', 'streams', 'init_states',
                    'thresh', 'syms_out')])


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected {dtype} {tuple(shape)} on {device}, '
                         f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def wavefront_forward(mode: int, weights: FoldedWeights,
                      latent_shape: Tuple[int, int, int], *, true_syms=None,
                      streams=None, init_states=None, thresh=None):
    """Kernel 2 wrapper. Same contract as wavefront_forward_plain (without
    return_logits); a CPU tensor runs the plain version, a CUDA tensor
    launches csrc/wavefront_forward.cu."""
    if mode not in (MODE_DECODE, MODE_ENCODE):
        raise ValueError(f'mode must be 0 (decode) or 1 (encode), got {mode}')
    dev = weights.w1.device
    if dev.type == 'cpu':
        return wavefront_forward_plain(mode, weights, latent_shape,
                                       true_syms=true_syms, streams=streams,
                                       init_states=init_states, thresh=thresh)
    if dev.type != 'cuda':
        raise ValueError(f'wavefront_forward: unsupported device {dev}')
    sched = build_schedule(latent_shape)
    tabs = device_tables(sched.latent_shape, str(dev))
    n = int(np.prod(sched.latent_shape))
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    if not 2 <= L <= MAX_L:
        raise ValueError(f'num_centers must be in [2, {MAX_L}], got {L}')
    params = weights.packed()
    _check_cuda('params', params, torch.float32, params.shape, dev)
    f32, i32 = torch.float32, torch.int32
    dummy = torch.zeros(1, dtype=i32, device=dev)
    if mode == MODE_ENCODE:
        B = true_syms.shape[0]
        _check_cuda('true_syms', true_syms, i32, (B, n), dev)
        fsel = torch.empty(B, sched.T, sched.CQ, dtype=i32, device=dev)
        ssel = torch.empty_like(fsel)
        streams = init_states = thresh = syms = dummy
        cap = 1
    else:
        B = streams.shape[0]
        cap = sched.stream_cap
        _check_cuda('streams', streams, i32, (B, cap), dev)
        _check_cuda('init_states', init_states, i32, (B, R), dev)
        _check_cuda('thresh', thresh, i32, (B, R), dev)
        syms = torch.empty(B, n, dtype=i32, device=dev)
        true_syms = fsel = ssel = dummy
    G = [c.G for c in sched.layers[:3]]
    acts = [torch.empty(B, g + 1, kf, dtype=f32, device=dev) for g in G]
    logits = torch.empty(B, n, L, dtype=f32, device=dev)
    qbuf = torch.empty(B, n + 1, dtype=f32, device=dev)
    p = build.ptr
    a = _FwdArgs(mode=mode, B=B, T=sched.T, n=n, kf=kf, L=L, CQ=sched.CQ,
                 cap=cap, G1=G[0], G2=G[1], G3=G[2], params=p(params),
                 skip3=p(tabs.skip), idx_cm=p(tabs.idx_cm), act1=p(acts[0]),
                 act2=p(acts[1]), act3=p(acts[2]), logits=p(logits), qbuf=p(qbuf),
                 true_syms=p(true_syms), fsel=p(fsel), ssel=p(ssel),
                 streams=p(streams), init_states=p(init_states),
                 thresh=p(thresh), syms_out=p(syms))
    for l in range(4):
        setattr(a, f'ptr{l + 1}', p(tabs.ptr[l]).value)
        setattr(a, f'cells{l + 1}', p(tabs.cells[l]).value)
        setattr(a, f'taps{l + 1}', p(tabs.taps[l]).value)
    fn = build.load('wavefront_forward').wavefront_forward
    fn.argtypes = [_FwdArgs, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(a, build.stream_ptr(dev))
    build.LAUNCHES['wavefront_forward_encode' if mode == MODE_ENCODE
                   else 'wavefront_forward_decode'] += 1
    build.check(err, 'wavefront_forward')
    return (fsel, ssel) if mode == MODE_ENCODE else syms


# ---------------------------------------------------------------------------
# Kernel 3: reverse interleaved rANS encoder
# ---------------------------------------------------------------------------

def reverse_plain(fsel: torch.Tensor, ssel: torch.Tensor, active: np.ndarray,
                  cap: int, x0: int = rans.RANS_L):
    """Reverse interleaved rANS over any (rows, CQ) activity table: walk rows
    T-1..0 and their R-lane chunks S-1..0 of the (B, T, CQ) tables. Returns
    (words (B, cap) int32 in emission order, n_words (B,) int32, states
    (B, R) int32 holding the uint32 bits, k (B, R) int32 warmup counts);
    image b's decode-order stream is words[b, :n_words[b]] reversed."""
    dev = fsel.device
    B, T, CQ = fsel.shape
    act = torch.from_numpy(active).to(dev)
    words = torch.zeros(B, cap, dtype=torch.long, device=dev)
    states = torch.full((B, R), x0, dtype=torch.long, device=dev)
    gw = torch.zeros(B, dtype=torch.long, device=dev)
    kw = torch.zeros(B, R, dtype=torch.long, device=dev)
    f_all, s_all = fsel.long(), ssel.long()
    for t in range(T - 1, -1, -1):
        for si in range(CQ // R - 1, -1, -1):
            lanes = slice(si * R, (si + 1) * R)
            if not active[t, lanes].any():
                continue
            a = act[t, lanes]
            states, gw, kw = rans.encode_reverse_step_interleaved(
                states, gw, kw, f_all[:, t, lanes], s_all[:, t, lanes],
                a[None].expand(B, R), words, x0 < rans.RANS_L)
    return words.int(), gw.int(), to_int32_bits(states), kw.int()


def reverse_launch(fsel: torch.Tensor, ssel: torch.Tensor, idx_cm: torch.Tensor,
                   n: int, cap: int, x0: int):
    """Launch csrc/rans_reverse.cu on (B, T, CQ) int32 CUDA tables; a lane
    (t, c) is active where idx_cm[t, c] < n. Same outputs as reverse_plain.
    Counts no launch: each caller counts its own."""
    if not 1 <= x0 <= rans.RANS_L:
        raise ValueError(f'x0 must be in [1, RANS_L], got {x0}')
    dev = fsel.device
    B, T, CQ = fsel.shape
    i32 = torch.int32
    _check_cuda('fsel', fsel, i32, (B, T, CQ), dev)
    _check_cuda('ssel', ssel, i32, (B, T, CQ), dev)
    _check_cuda('idx_cm', idx_cm, i32, (T, CQ), dev)
    words = torch.empty(B, cap, dtype=i32, device=dev)
    n_words = torch.empty(B, dtype=i32, device=dev)
    states = torch.empty(B, R, dtype=i32, device=dev)
    kw = torch.empty(B, R, dtype=i32, device=dev)
    fn = build.load('rans_reverse').rans_reverse
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint] + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    p = build.ptr
    with torch.cuda.device(dev):
        err = fn(B, T, CQ, n, cap, x0, p(idx_cm), p(fsel), p(ssel), p(words),
                 p(n_words), p(states), p(kw), build.stream_ptr(dev))
    build.check(err, 'rans_reverse')
    return words, n_words, states, kw


def rans_reverse_plain(fsel: torch.Tensor, ssel: torch.Tensor,
                       latent_shape: Tuple[int, int, int], x0: int = rans.RANS_L):
    """Plain version of kernel 3 over the wavefront's chunk-major (B, T, CQ)
    tables; outputs as reverse_plain."""
    sched = build_schedule(latent_shape)
    n = int(np.prod(sched.latent_shape))
    return reverse_plain(fsel, ssel, sched.idx_cm < n, sched.stream_cap, x0)


def rans_reverse(fsel: torch.Tensor, ssel: torch.Tensor,
                 latent_shape: Tuple[int, int, int], x0: int = rans.RANS_L):
    """Kernel 3 wrapper; same contract as rans_reverse_plain."""
    if not 1 <= x0 <= rans.RANS_L:
        raise ValueError(f'x0 must be in [1, RANS_L], got {x0}')
    if fsel.device.type == 'cpu':
        return rans_reverse_plain(fsel, ssel, latent_shape, x0)
    if fsel.device.type != 'cuda':
        raise ValueError(f'rans_reverse: unsupported device {fsel.device}')
    sched = build_schedule(latent_shape)
    tabs = device_tables(sched.latent_shape, str(fsel.device))
    out = reverse_launch(fsel, ssel, tabs.idx_cm, int(np.prod(sched.latent_shape)),
                         sched.stream_cap, x0)
    build.LAUNCHES['rans_reverse'] += 1
    return out
