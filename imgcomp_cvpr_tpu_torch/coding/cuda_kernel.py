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

Kernel 2 (csrc/wavefront_forward.cu) has two entries. The encode entry is
layer-parallel: all symbols are known, so every cell of a layer depends only
on the layer below, and one launch per layer covers all cells of all images,
then one launch writes the per-symbol (freq, start) tables. The scan entry
runs the steps in order, one image over a thread-block cluster: layer 1..4
cells of step t, then the step's rANS lanes; mode 0 (decode) runs the
sequential 32-lane interleaved rANS decode, mode 1 is the teacher-forced
scan kept as the encode's consistency oracle. All of them compute logits and
CDFs with the same two device functions. Kernel 3 (csrc/rans_reverse.cu, one
block per image: a chain warp fed by two producer warps and drained by a
writer warp) is the reverse interleaved rANS encoder; it walks a host-built
list of the non-empty sub-iterations (reverse_list).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

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
    slot4: np.ndarray              # (n,) int32 idx_cm column of each L4 cell


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
    # Layer 4's grid is the latent: the column of the step's idx_cm row that
    # holds each of its cells (the cells are sorted by step).
    tt, cc = np.nonzero(idx_cm < n)
    col = np.empty(n, np.int32)
    col[idx_cm[tt, cc]] = cc
    slot4 = col[layers[3].cells]
    step4 = np.repeat(np.arange(T), np.diff(layers[3].ptr))
    assert (idx_cm[step4, slot4] == layers[3].cells).all()
    return Schedule(latent_shape=latent_shape, T=T, S=S, CQ=CQ,
                    chunk_offs=chunk_offs, idx_cm=idx_cm,
                    stream_cap=(wcap // 128 + 2) * 128,
                    layers=tuple(layers), skip=skip, slot4=slot4)


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
    slot4: torch.Tensor               # (n,) int32
    idx_cm: torch.Tensor              # (T, CQ) int32


@functools.lru_cache(maxsize=8)
def device_tables(latent_shape: Tuple[int, int, int], device: str) -> DeviceTables:
    sched = build_schedule(latent_shape)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return DeviceTables(ptr=tuple(t(c.ptr) for c in sched.layers),
                        cells=tuple(t(c.cells) for c in sched.layers),
                        taps=tuple(t(c.taps) for c in sched.layers),
                        skip=t(sched.skip), slot4=t(sched.slot4),
                        idx_cm=t(sched.idx_cm))


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
# Operand precisions of kernel 2 (the container's prec byte 0 / 1 / 2)
# ---------------------------------------------------------------------------

# make_forward's prec values, indexed by the container's prec byte.
PRECS = ('f32', 'bf16', 'f8')
# How kernel 2 stores its operands at each precision (csrc/layer_sum.cuh's
# Operand<P>): the activations that later layers read as taps, and q.
ACT_DTYPE = (torch.float32, torch.bfloat16, torch.float8_e4m3fn)
Q_DTYPE = (torch.float32, torch.bfloat16, torch.bfloat16)
# The type the tap inputs of layers 2-4 are rounded to (make_forward's
# ring_dt); layer 1's q operands are bf16 at precisions 1 and 2 (its r0_dt).
RING_KIND = (None, 'bf16', 'e4m3')
# e4m3fn's largest finite value is 448; RNE sends |x| > 464 past it.
_E4M3_OVERFLOW = 464.0


def prec_id(prec) -> int:
    """A precision as 'f32' / 'bf16' / 'f8' or as its prec byte 0 / 1 / 2 ->
    the prec byte."""
    if isinstance(prec, str) and prec in PRECS:
        return PRECS.index(prec)
    if isinstance(prec, (int, np.integer)) and not isinstance(prec, bool) \
            and 0 <= prec < len(PRECS):
        return int(prec)
    raise ValueError(f'unknown precision {prec!r}; expected one of {PRECS} or 0, 1, 2')


def round_operand(x: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """float32 x rounded to ``kind`` and back to float32, as XLA converts:
    'bf16' rounds to nearest even; 'e4m3' (float8_e4m3fn) rounds to nearest
    even with subnormals and gives NaN past the largest finite value (XLA's
    convert does not saturate, torch's cast saturates on the CPU, so the
    overflow is set apart here). None returns x."""
    if kind is None:
        return x
    if kind == 'bf16':
        return x.to(torch.bfloat16).float()
    if kind == 'e4m3':
        return torch.where(x.abs() > _E4M3_OVERFLOW, float('nan'),
                           x.to(torch.float8_e4m3fn).float())
    raise ValueError(f'unknown operand kind {kind!r}')


def operand_weights(weights: FoldedWeights, prec) -> FoldedWeights:
    """The folded weights as kernel 2 reads them at precision ``prec``
    (pallas_kernel.py:647-652, 690-696, 1025): at 1 and 2 the layer weights
    and layer 1's q operands (centers, pad value) in bf16, the all-pad
    constants k1..k3 (layers 2-4's pad inputs) in the ring's type; the
    biases stay float32. Rounding twice is rounding once; precision 0
    returns ``weights``."""
    p = prec_id(prec)
    if p == 0:
        return weights
    bf, ring = (lambda a: round_operand(a, 'bf16')), RING_KIND[p]
    w = weights
    return FoldedWeights(bf(w.w1), w.b1, bf(w.w2), w.b2, bf(w.w3), w.b3, bf(w.w4), w.b4,
                         round_operand(w.k1, ring), round_operand(w.k2, ring),
                         round_operand(w.k3, ring), bf(w.pad), bf(w.centers))


# ---------------------------------------------------------------------------
# CDF quantization (plain twin of the kernels' shared __device__ function)
# ---------------------------------------------------------------------------

def exp_host(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 CPU tensor, each element a function of that element
    alone: numpy's float64 exp, rounded to float32.

    torch.exp does not give that on the CPU. ATen hands each OpenMP thread
    its share of the tensor and each calls MKL's vmsExp, and MKL picks its
    code path at its first call in a process. When two threads make that
    first call at once, one of them can run its share through MKL's AVX2
    path at EP accuracy (relative error up to 1.4e-4) instead of the
    AVX-512 path at HA accuracy (within 1 ulp), so the CDFs of the first
    large exp in a process (the encode's tables) could differ from those of
    the decode's later, smaller ones. numpy calls no MKL and no threads.
    The result equals MKL's HA value but on up to ~2 elements in a
    thousand, where the two are neighbouring floats (1 ulp apart) and this
    one is the nearer to exp."""
    return torch.from_numpy(np.exp(x.detach().numpy().astype(np.float64)).astype(np.float32))


def logits_to_cdf(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., L) f32 logits -> (freq, cdf_low) int64: softmax with a
    sequential sum over L, then rans.quantize_cdf. The same order of
    operations as cdf_from_logits in csrc/wavefront_forward.cu; on the CPU
    the exponentials are exp_host's, on a card torch.exp's, which is the
    kernels' expf.

    Non-finite logits follow the JAX kernel (pallas_kernel.py's
    _quantize_cdf_kernel) op by op. A column holding a NaN or a +inf logit
    (inf - inf is NaN) gets NaN probabilities. floor(NaN) converts to 0, as
    XLA and the card convert it, so each symbol gets freq 1. No probability
    equals the column's max (NaN), so no symbol takes the deficit. The
    column is freq 1 for every symbol with cdf_low l, summing to L; the
    rANS coders take it as it is (slot = start for freq 1). A -inf logit
    only gives its symbol p = 0 (a column of -inf alone is NaN). The
    kernels' csrc/cdf.cuh::cdf_from_logits states the same rule."""
    m = logits.max(-1, keepdim=True).values
    d = logits - m
    e = exp_host(d) if d.device.type == 'cpu' else torch.exp(d)
    s = e[..., 0]
    for l in range(1, e.shape[-1]):
        s = s + e[..., l]
    return rans.quantize_cdf(e / s[..., None])


# ---------------------------------------------------------------------------
# Kernel 2: wavefront forward (encode / decode)
# ---------------------------------------------------------------------------

MODE_DECODE, MODE_ENCODE = 0, 1


_ACC_BLOCK_FLOATS = 1 << 22   # products a block of layer_sum's host chain
_SUM_CHUNK_FLOATS = 1 << 26   # products a chunk of layer_sum on a card


def layer_sum(x: torch.Tensor, wf: torch.Tensor, b) -> torch.Tensor:
    """The port's one layer sum: x (..., rows) gathered inputs in (tap, input
    channel) order, wf (rows, cout) -> (..., cout) pre-activation, summed
    over the rows in order with one rounded multiply and one rounded add at
    a time, then the bias (the order of kernels 2 and 5). On the host, the
    rounded products of a block of rows, the running sum added to its first,
    then numpy's add.accumulate, which adds in order in float32. On a card,
    the rounded products, then torch.cumsum over the rows, which CUDA scans
    in order for a dimension that is not the innermost one. ``b`` broadcasts
    against the result."""
    rows, cout = wf.shape
    x2 = x.reshape(-1, rows)
    if x.device.type == 'cpu':
        xn, wn = x2.detach().numpy(), wf.detach().numpy()
        acc = np.zeros((xn.shape[0], cout), np.float32)
        blk = max(1, _ACC_BLOCK_FLOATS // max(1, acc.size))
        for j in range(0, rows, blk):
            p = xn[:, j:j + blk, None] * wn[j:j + blk]
            p[:, 0, :] += acc
            acc = np.add.accumulate(p, axis=1)[:, -1, :]
        out = torch.from_numpy(np.ascontiguousarray(acc))
    else:
        step = max(1, _SUM_CHUNK_FLOATS // (rows * cout))
        parts = [torch.cumsum(x2[a:a + step, :, None] * wf, 1)[:, -1]
                 for a in range(0, x2.shape[0], step)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out.reshape(*x.shape[:-1], cout) + b


def _layer_step(src: torch.Tensor, taps: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, kind: Optional[str] = None) -> torch.Tensor:
    """src (B, G+1, cin), taps (nc, ntaps) -> (B, nc, cout) pre-activation,
    accumulated in the kernel's order (layer_sum), the gathered inputs
    rounded to ``kind`` first (round_operand: the values kernel 2 stores
    and its sums read at its precisions). On a card this plain version
    keeps its loop over the (tap, channel) rows, one launch each: the same
    bits as layer_sum's cumsum, and the time that PERF.md's kernel table
    records as kernels 2 and 5's plain versions."""
    x = round_operand(src[:, taps.long()], kind)           # (B, nc, ntaps, cin)
    x = x.reshape(x.shape[0], x.shape[1], taps.shape[1] * src.shape[2])   # nc may be 0
    wf = w.reshape(-1, w.shape[-1])
    if x.device.type == 'cpu':
        return layer_sum(x, wf, b)
    acc = torch.zeros(x.shape[0], x.shape[1], wf.shape[1], dtype=x.dtype,
                      device=x.device)
    for j in range(wf.shape[0]):
        acc = acc + x[..., j, None] * wf[j]
    return acc + b


def wavefront_forward_plain(mode: int, weights: FoldedWeights,
                            latent_shape: Tuple[int, int, int], *,
                            true_syms=None, streams=None, init_states=None,
                            thresh=None, return_logits: bool = False, prec=0):
    """Plain PyTorch version of kernel 2: a Python loop over the T steps,
    vectorised over the step's cells and the batch, with the kernel's layer
    and sub-iteration order. At precision ``prec`` (PRECS) the weights and
    q operands are operand_weights' and layers 2-4 round their tap inputs to
    RING_KIND; layer 3's skip adds layer 1's float32 output
    (pallas_kernel.py:828, 836).

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
    weights, ring = operand_weights(weights, prec), RING_KIND[prec_id(prec)]
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
            y = _layer_step(src, tabs.taps[li][sl[li]], *layer_w[li], ring if li else None)
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


_PLAIN_CHUNK_FLOATS = 1 << 25   # gathered (B, cells, taps * cin) floats a chunk


def layer_all_cells(src: torch.Tensor, taps: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor, kind: Optional[str] = None) -> torch.Tensor:
    """_layer_step over every cell of a layer, in chunks of cells (the
    gathered taps of a whole Kodak-size layer would take gigabytes).
    taps (N, ntaps) int64 on src's device; b broadcasts against (B, N, cout)
    or is a per-cell bias (B, N, cout); ``kind`` as in _layer_step."""
    n_cells = taps.shape[0]
    chunk = max(1, _PLAIN_CHUNK_FLOATS // (src.shape[0] * taps.shape[1] * src.shape[-1]))
    out = []
    for a in range(0, n_cells, chunk):
        bb = b[:, a:a + chunk] if b.dim() == 3 else b
        out.append(_layer_step(src, taps[a:a + chunk], w, bb, kind))
    return torch.cat(out, 1)


def tables_from_logits(logits: torch.Tensor, idx_cm: torch.Tensor,
                       true_syms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B, n, L), idx_cm (rows, CQ) int64 (n on dead lanes), true_syms
    (B, n) -> (fsel, ssel) (B, rows, CQ) int32, 0 on dead lanes: the CDF of
    each live lane's cell and the true symbol's (freq, start)."""
    B, n, _ = logits.shape
    rows, CQ = idx_cm.shape
    fsel = torch.zeros(B, rows, CQ, dtype=torch.int32, device=logits.device)
    ssel = torch.zeros_like(fsel)
    true_l = true_syms.long()
    step = max(1, (1 << 22) // (B * CQ))
    for a in range(0, rows, step):
        idx = idx_cm[a:a + step]
        act = idx < n
        idx_c = torch.clamp(idx, max=n - 1).reshape(-1)
        fq, cl = logits_to_cdf(logits[:, idx_c])
        sym = true_l[:, idx_c][..., None]
        fs = torch.gather(fq, -1, sym)[..., 0].reshape(B, *idx.shape)
        ss = torch.gather(cl, -1, sym)[..., 0].reshape(B, *idx.shape)
        fsel[:, a:a + step] = torch.where(act, fs, 0).int()
        ssel[:, a:a + step] = torch.where(act, ss, 0).int()
    return fsel, ssel


def wavefront_encode_plain(weights: FoldedWeights, latent_shape: Tuple[int, int, int],
                           true_syms: torch.Tensor, return_logits: bool = False, prec=0):
    """Plain PyTorch version of kernel 2's layer-parallel encode: all cells
    of layer 1, then 2, 3, 4 through _layer_step (each output the same chain
    of roundings as in the step-ordered plain version, so the tables are
    equal to its), then the CDFs of all (T, CQ) lanes. true_syms (B, n) int
    -> (freq_sel, start_sel) (B, T, CQ) int32, 0 on dead lanes. ``prec`` as
    in wavefront_forward_plain."""
    sched = build_schedule(latent_shape)
    weights, ring = operand_weights(weights, prec), RING_KIND[prec_id(prec)]
    dev = weights.w1.device
    tabs = device_tables(sched.latent_shape, str(dev))
    B = true_syms.shape[0]
    src = torch.cat([weights.centers[true_syms.long()],
                     weights.pad.expand(B, 1)], 1)[:, :, None]
    layer_w = ((weights.w1, weights.b1), (weights.w2, weights.b2),
               (weights.w3, weights.b3), (weights.w4, weights.b4))
    consts = (weights.k1, weights.k2, weights.k3)
    act1 = None
    for li in range(4):
        y = layer_all_cells(src, tabs.taps[li].long(), *layer_w[li], ring if li else None)
        if li == 2:
            y = y + act1[:, tabs.skip.long()]
        else:
            y = torch.relu(y)
        if li == 3:
            logits = torch.empty_like(y)
            logits[:, tabs.cells[3].long()] = y
            break
        src = torch.empty(B, sched.layers[li].G + 1, y.shape[-1], dtype=y.dtype, device=dev)
        src[:, -1] = consts[li]
        src[:, tabs.cells[li].long()] = y
        if li == 0:
            act1 = src
    out = tables_from_logits(logits, tabs.idx_cm.long(), true_syms)
    return (out, logits) if return_logits else out


class _FwdArgs(ctypes.Structure):
    _fields_ = ([('mode', ctypes.c_int), ('B', ctypes.c_int), ('T', ctypes.c_int),
                 ('n', ctypes.c_int), ('kf', ctypes.c_int), ('L', ctypes.c_int),
                 ('CQ', ctypes.c_int), ('cap', ctypes.c_int),
                 ('G1', ctypes.c_int), ('G2', ctypes.c_int), ('G3', ctypes.c_int),
                 ('cluster', ctypes.c_int), ('N1', ctypes.c_int), ('N2', ctypes.c_int),
                 ('N3', ctypes.c_int), ('N4', ctypes.c_int), ('force', ctypes.c_int),
                 ('prec', ctypes.c_int), ('params', ctypes.c_void_p)]
                + [(f'{k}{l}', ctypes.c_void_p) for l in range(1, 5)
                   for k in ('ptr', 'cells', 'taps')]
                + [(k, ctypes.c_void_p) for k in (
                    'skip3', 'slot4', 'idx_cm', 'act1', 'act2', 'act3', 'act1f', 'logits',
                    'qbuf',
                    'true_syms', 'fsel', 'ssel', 'streams', 'init_states',
                    'thresh', 'syms_out', 'prof')])


_FWD_ARGTYPES = (_FwdArgs, ctypes.c_void_p)     # (arguments, stream)


def _check_cuda(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected {dtype} {tuple(shape)} on {device}, '
                         f'got {t.dtype} {tuple(t.shape)} on {t.device}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


MAX_CLUSTER = 8  # blocks an image in the scan: the portable cluster limit
# FwdArgs::force / PlaneArgs::force bits (csrc/wavefront_forward.cu,
# csrc/plane_forward.cu): the weights in device memory even where they fit in
# shared memory; the generic instance even where a compile-time one exists.
FORCE_WDEV, FORCE_GENERIC = 1, 2


def launch_name(base: str, prec) -> str:
    """The LAUNCHES counter of kernel 2's entry ``base`` at a precision: the
    base name at precision 0, with '_bf16' or '_f8' at 1 or 2."""
    p = prec_id(prec)
    return base if p == 0 else f'{base}_{PRECS[p]}'


def wavefront_forward(mode: int, weights: FoldedWeights,
                      latent_shape: Tuple[int, int, int], *, true_syms=None,
                      streams=None, init_states=None, thresh=None,
                      scan: bool = False, cluster: Optional[int] = None, prof=None,
                      force: int = 0, prec=0):
    """Kernel 2 wrapper. Same contract as wavefront_forward_plain (without
    return_logits). Encode (mode 1) takes the layer-parallel entry, or with
    ``scan`` the step-ordered scan (its consistency oracle: the tables are
    equal); decode (mode 0) is the scan, one image over ``cluster`` blocks
    (default: the largest cluster at which the whole batch runs at once).
    ``prof`` (B, 10) int64 on the device receives the scan's clocks per phase
    and barrier. ``force`` (FORCE_WDEV | FORCE_GENERIC) takes a placement or
    instance the kernel would not choose itself, for comparisons; the tables
    and symbols are the same bits. ``prec`` (PRECS, or the prec byte) is the
    operand precision: the kernel's instance of it stores q and the
    activations at ACT_DTYPE / Q_DTYPE (layer 1 in float32 too, for layer
    3's skip), and gets the weights as operand_weights rounds them. A CPU
    tensor runs the plain versions, a CUDA tensor launches
    csrc/wavefront_forward.cu."""
    if mode not in (MODE_DECODE, MODE_ENCODE):
        raise ValueError(f'mode must be 0 (decode) or 1 (encode), got {mode}')
    parallel = mode == MODE_ENCODE and not scan
    pid = prec_id(prec)
    dev = weights.w1.device
    if dev.type == 'cpu':
        if parallel:
            return wavefront_encode_plain(weights, latent_shape, true_syms, prec=pid)
        return wavefront_forward_plain(mode, weights, latent_shape,
                                       true_syms=true_syms, streams=streams,
                                       init_states=init_states, thresh=thresh, prec=pid)
    if dev.type != 'cuda':
        raise ValueError(f'wavefront_forward: unsupported device {dev}')
    weights = operand_weights(weights, pid)
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
    if cluster is None:
        cluster = 1 if parallel else scan_cluster(kf, L, sched.CQ, sched.T, B, pid)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f'cluster must be in [1, {MAX_CLUSTER}], got {cluster}')
    # The operands at their storage type (already rounded to it: exact).
    G = [c.G for c in sched.layers[:3]]
    acts = [torch.empty(B, g + 1, kf, dtype=ACT_DTYPE[pid], device=dev) for g in G]
    for a_l, k in zip(acts, (weights.k1, weights.k2, weights.k3)):
        a_l[:, -1] = k                        # the all-pad constant rows
    act1f = acts[0]
    if pid:                                   # layer 1 in float32 for the skip
        act1f = torch.empty(B, G[0] + 1, kf, dtype=f32, device=dev)
        act1f[:, -1] = weights.k1
    if parallel:
        qbuf = torch.cat([weights.centers[true_syms.long()],
                          weights.pad.expand(B, 1)], 1).to(Q_DTYPE[pid]).contiguous()
        logits = torch.empty(B, n, L, dtype=f32, device=dev)
    else:
        qbuf = torch.empty(B, n + 1, dtype=Q_DTYPE[pid], device=dev)
        qbuf[:, n] = weights.pad
        logits = torch.zeros(1, dtype=f32, device=dev)   # stays on the chip
    p = build.ptr
    a = _FwdArgs(mode=mode, B=B, T=sched.T, n=n, kf=kf, L=L, CQ=sched.CQ,
                 cap=cap, G1=G[0], G2=G[1], G3=G[2], cluster=cluster,
                 N1=len(sched.layers[0].cells), N2=len(sched.layers[1].cells),
                 N3=len(sched.layers[2].cells), N4=len(sched.layers[3].cells),
                 force=force, prec=pid, params=p(params), skip3=p(tabs.skip), slot4=p(tabs.slot4),
                 idx_cm=p(tabs.idx_cm), act1=p(acts[0]), act2=p(acts[1]),
                 act3=p(acts[2]), act1f=p(act1f), logits=p(logits), qbuf=p(qbuf),
                 true_syms=p(true_syms), fsel=p(fsel), ssel=p(ssel),
                 streams=p(streams), init_states=p(init_states),
                 thresh=p(thresh), syms_out=p(syms),
                 prof=None if prof is None else p(prof))
    for l in range(4):
        setattr(a, f'ptr{l + 1}', p(tabs.ptr[l]).value)
        setattr(a, f'cells{l + 1}', p(tabs.cells[l]).value)
        setattr(a, f'taps{l + 1}', p(tabs.taps[l]).value)
    fn = build.entry('wavefront_forward', 'wavefront_encode' if parallel else
                     'wavefront_forward', _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(a, build.stream_ptr(dev))
    build.LAUNCHES[launch_name('wavefront_forward_encode' if parallel else
                               'wavefront_forward_encode_scan' if mode == MODE_ENCODE
                               else 'wavefront_forward_decode', pid)] += 1
    if weights_in_device(kf, L, sched.CQ, sched.T, parallel, force, pid):
        build.LAUNCHES['wavefront_wdev'] += 1
    build.check(err, 'wavefront_forward')
    return (fsel, ssel) if mode == MODE_ENCODE else syms


@functools.lru_cache(maxsize=64)
def max_active_clusters(kf: int, L: int, CQ: int, T: int, cluster: int, prec: int = 0) -> int:
    """cudaOccupancyMaxActiveClusters of the scan kernel (its instance of
    precision ``prec``): how many images the card scans at once with
    ``cluster`` blocks an image."""
    fn = build.entry('wavefront_forward', 'wavefront_max_clusters', (ctypes.c_int,) * 6)
    out = fn(kf, L, CQ, T, cluster, prec_id(prec))
    if out < 0:
        raise RuntimeError(f'cudaOccupancyMaxActiveClusters: cudaError {-out}')
    return out


@functools.lru_cache(maxsize=64)
def weights_in_device(kf: int, L: int, CQ: int, T: int, encode: bool = False,
                      force: int = 0, prec=0) -> bool:
    """Whether kernel 2's scan (or, with ``encode``, its layer-parallel
    encode) reads the weights from device memory at these widths: they do not
    fit in a block's shared memory beside the rest (kf >= ~39 at L = 6 and
    the Kodak latent), or ``force`` asks for it."""
    fn = build.entry('wavefront_forward', 'wavefront_weights_in_device', (ctypes.c_int,) * 7)
    out = fn(kf, L, CQ, T, force, int(encode), prec_id(prec))
    if out < 0:
        raise RuntimeError(f'wavefront_weights_in_device: cudaError {-out}')
    return bool(out)


def scan_cluster(kf: int, L: int, CQ: int, T: int, B: int, prec: int = 0) -> int:
    """Blocks an image for a scan of B images: the largest cluster size at
    which the card holds all B clusters at once (a cluster lies inside one
    GPC, so an H100 holds 15 clusters of 8 blocks but 17 of 6; a 16th image
    on clusters of 8 would wait for a second wave), else 1."""
    for c in range(MAX_CLUSTER, 1, -1):
        if max_active_clusters(kf, L, CQ, T, c, prec) >= B:
            return c
    return 1


# ---------------------------------------------------------------------------
# Kernel 3: reverse interleaved rANS encoder
# ---------------------------------------------------------------------------

def reverse_list(active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The non-empty R-lane sub-iterations of an activity table in coding
    order (last first), as kernels 3 and 6 walk them. active (rows, W) bool
    with W a multiple of R, viewed as (rows * W / R, R) lane rows -> (row
    (E,) int32: index of the lane row, mask (E,) uint32: bit l set where
    lane l is active)."""
    a = np.asarray(active, bool).reshape(-1, R)
    bits = (a.astype(np.uint64) << np.arange(R, dtype=np.uint64)).sum(1)
    rows = np.nonzero(bits)[0][::-1]
    return rows.astype(np.int32), bits[rows].astype(np.uint32)


REVERSE_LIST_PAD = 32   # the kernel's tiles of list entries divide this
REVERSE_PROF = 7        # profile columns an image (NPROF in csrc/rans_reverse.cu)
_REVERSE_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_uint,) + (ctypes.c_void_p,) * 10


class ReverseList(NamedTuple):
    E: int                 # non-empty sub-iterations
    row: torch.Tensor      # (E padded,) int32 lane row of each; padding row 0
    mask: torch.Tensor     # (E padded,) int32 its lane mask (uint32 bits); padding 0


def reverse_list_to(active: np.ndarray, device: str) -> ReverseList:
    """reverse_list on the device, padded with empty entries (row 0, mask 0)
    to a multiple of REVERSE_LIST_PAD so that the kernel stages whole
    tiles."""
    rows, masks = reverse_list(active)
    E = len(rows)
    n = _round_up(max(E, 1), REVERSE_LIST_PAD)
    row_p, mask_p = np.zeros(n, np.int32), np.zeros(n, np.uint32)
    row_p[:E], mask_p[:E] = rows, masks
    return ReverseList(E, torch.from_numpy(row_p).to(device),
                       torch.from_numpy(mask_p.view(np.int32)).to(device))


@functools.lru_cache(maxsize=8)
def device_reverse_list(latent_shape: Tuple[int, int, int], device: str) -> ReverseList:
    sched = build_schedule(latent_shape)
    return reverse_list_to(sched.idx_cm < int(np.prod(sched.latent_shape)), device)


def _rdiv_q0(x: np.ndarray, f: np.ndarray) -> np.ndarray:
    """floor(x m / 2^32) with the reciprocal m = floor((2^32 - 1) / f): x // f
    or one less."""
    return (x * (np.uint64(0xFFFFFFFF) // f)) >> np.uint64(32)


def rdiv_divmod(x: np.ndarray, f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x // f and x % f as csrc/rans_reverse.cu's rdiv_update finds them: the
    quotient from the reciprocal, and one correction. x uint32-valued, f in
    [1, 65536]; uint64 out."""
    x, f = (np.asarray(v, np.uint64) for v in (x, f))
    q0 = _rdiv_q0(x, f)
    fix = x - q0 * f >= f
    return q0 + fix, x - (q0 + fix) * f


def rdiv_update(x: np.ndarray, f: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Numpy twin of rdiv_update in csrc/rans_reverse.cu: ((x // f) << 16) +
    (x % f) + s mod 2^32 as q0 (65536 - f) + x + s, plus 65536 - f where
    the quotient needs its correction. x, s uint32-valued, f in [1, 65536]."""
    x, f, s = (np.asarray(v, np.uint64) for v in (x, f, s))
    mask = np.uint64(0xFFFFFFFF)
    q0 = _rdiv_q0(x, f)
    g = np.uint64(65536) - f
    y = (q0 * g + x + s) & mask
    return np.where(x - q0 * f >= f, (y + g) & mask, y)


def reverse_plain_list(fsel: torch.Tensor, ssel: torch.Tensor, rows: np.ndarray,
                       masks: np.ndarray, cap: int, x0: int = rans.RANS_L):
    """Reverse interleaved rANS, the plain version of kernels 3 and 6: runs
    exactly the lane rows of a reverse_list (rows, masks) of the (B, ..., W)
    tables, in list order, with the listed lanes active. Returns (words (B,
    cap) int32 in emission order, n_words (B,) int32, states (B, R) int32
    holding the uint32 bits, k (B, R) int32 warmup counts); image b's
    decode-order stream is words[b, :n_words[b]] reversed."""
    dev = fsel.device
    B = fsel.shape[0]
    f_all, s_all = fsel.reshape(B, -1, R).long(), ssel.reshape(B, -1, R).long()
    lane_bits = torch.tensor([1 << l for l in range(R)], dtype=torch.long, device=dev)
    words = torch.zeros(B, cap, dtype=torch.long, device=dev)
    states = torch.full((B, R), x0, dtype=torch.long, device=dev)
    gw = torch.zeros(B, dtype=torch.long, device=dev)
    kw = torch.zeros(B, R, dtype=torch.long, device=dev)
    for row, mask in zip(np.asarray(rows).tolist(), np.asarray(masks, np.uint32).tolist()):
        a = (lane_bits & mask) != 0
        states, gw, kw = rans.encode_reverse_step_interleaved(
            states, gw, kw, f_all[:, row], s_all[:, row], a[None].expand(B, R), words,
            x0 < rans.RANS_L)
    return words.int(), gw.int(), to_int32_bits(states), kw.int()


def reverse_launch(fsel: torch.Tensor, ssel: torch.Tensor, rlist: ReverseList,
                   cap: int, x0: int, prof: Optional[torch.Tensor] = None):
    """Launch csrc/rans_reverse.cu on (B, T, W) int32 CUDA tables (W a
    multiple of R) over the non-empty lane rows of ``rlist``. Same outputs
    as reverse_plain_list. ``prof`` (B, REVERSE_PROF) int64 on the device
    receives, per image: the chain warp's clocks, its clocks waiting for
    tiles, the sub-iterations run, the two producer warps' and the writer
    warp's clocks waiting, and the chain warp's clocks in its state updates.
    Counts no launch: each caller counts its own."""
    if not 1 <= x0 <= rans.RANS_L:
        raise ValueError(f'x0 must be in [1, RANS_L], got {x0}')
    dev = fsel.device
    B, T, W = fsel.shape
    if W % R:
        raise ValueError(f'table width {W} is not a multiple of {R}')
    i32 = torch.int32
    E, n = rlist.E, rlist.row.shape[0]
    if n % REVERSE_LIST_PAD or n < E:
        raise ValueError(f'list of {n} entries is not {E} padded to whole tiles')
    _check_cuda('fsel', fsel, i32, (B, T, W), dev)
    _check_cuda('ssel', ssel, i32, (B, T, W), dev)
    _check_cuda('list row', rlist.row, i32, (n,), dev)
    _check_cuda('list mask', rlist.mask, i32, (n,), dev)
    if prof is not None:
        _check_cuda('prof', prof, torch.int64, (B, REVERSE_PROF), dev)
    for name, t in (('fsel', fsel), ('ssel', ssel)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned (16-byte copies)')
    words = torch.empty(B, cap, dtype=i32, device=dev)
    n_words = torch.empty(B, dtype=i32, device=dev)
    states = torch.empty(B, R, dtype=i32, device=dev)
    kw = torch.empty(B, R, dtype=i32, device=dev)
    fn = build.entry('rans_reverse', 'rans_reverse', _REVERSE_ARGTYPES)
    p = build.ptr
    with torch.cuda.device(dev):
        err = fn(B, T * W // R, E, cap, x0, p(rlist.row), p(rlist.mask), p(fsel),
                 p(ssel), p(words), p(n_words), p(states), p(kw),
                 None if prof is None else p(prof), build.stream_ptr(dev))
    build.check(err, 'rans_reverse')
    return words, n_words, states, kw


def rans_reverse_plain(fsel: torch.Tensor, ssel: torch.Tensor,
                       latent_shape: Tuple[int, int, int], x0: int = rans.RANS_L):
    """Plain version of kernel 3 over the wavefront's chunk-major (B, T, CQ)
    tables; outputs as reverse_plain_list."""
    sched = build_schedule(latent_shape)
    n = int(np.prod(sched.latent_shape))
    return reverse_plain_list(fsel, ssel, *reverse_list(sched.idx_cm < n), sched.stream_cap, x0)


def rans_reverse(fsel: torch.Tensor, ssel: torch.Tensor,
                 latent_shape: Tuple[int, int, int], x0: int = rans.RANS_L,
                 prof: Optional[torch.Tensor] = None):
    """Kernel 3 wrapper; same contract as rans_reverse_plain. ``prof`` as in
    reverse_launch (CUDA only)."""
    if not 1 <= x0 <= rans.RANS_L:
        raise ValueError(f'x0 must be in [1, RANS_L], got {x0}')
    if fsel.device.type == 'cpu':
        return rans_reverse_plain(fsel, ssel, latent_shape, x0)
    if fsel.device.type != 'cuda':
        raise ValueError(f'rans_reverse: unsupported device {fsel.device}')
    sched = build_schedule(latent_shape)
    out = reverse_launch(fsel, ssel, device_reverse_list(sched.latent_shape, str(fsel.device)),
                         sched.stream_cap, x0, prof)
    build.LAUNCHES['rans_reverse'] += 1
    return out
