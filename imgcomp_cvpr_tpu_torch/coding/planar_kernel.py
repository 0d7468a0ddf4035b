"""Planar (K != 3) codec kernels for the H100: kernel 5 (one depth plane's 2D
wavefront, encode and decode) and kernel 6 (reverse interleaved rANS over the
(plane, step) rows), with their plain PyTorch versions.

Counterpart of imgcomp_cvpr_tpu/coding/planar_kernel.py. Kernel 5
(csrc/plane_forward.cu) has a scan and a layer-parallel encode. The scan
(plane_forward, one block per image) codes ONE plane: at step t it computes
the level 1..4 cells of that step (coding/planar.py) from the top-slice taps
of the current plane plus the plane's bias rows (the lower kernel slices
over the known planes, computed by PlanarCoder), then the step's band of at
most R = 32 symbols as one rANS chunk. Mode 0 (decode) runs the sequential
32-lane rANS decode with the per-plane tail-packing threshold; mode 1 is the
teacher-forced scan, kept as the encode's consistency oracle. The encode
itself is layer-parallel: the symbols are known, so level l of every plane
depends only on level l-1, and level_forward computes one level of all
(image, plane) pairs in one launch, plane_tables the (freq, start) of every
lane. All compute logits and CDFs with the same code (csrc/layer_sum.cuh,
csrc/cdf.cuh).

Layer math (ResShallow): conv0 (first mask) -> res conv1 (relu) -> res conv2
+ the same-step level-1 skip (no relu) -> conv_out (relu'd logits); each
layer adds its bias row. Every sum is accumulated over (tap, input channel)
with separately rounded multiplies and adds; the plain versions repeat
exactly those roundings.

Kernel 6 is csrc/rans_reverse.cu (kernel 3) driven over the planar
(C * T2, R) rows (S = 1 chunk per row) through the host-built list of the
non-empty rows; it has its own launch counter and plain version here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import build
from . import cuda_kernel as ck
from . import planar
from . import rans

R = planar.R
MAX_TAPS = 32     # top-slice taps per layer the kernel takes (K <= 7)
MAX_L = ck.MAX_L
MODE_DECODE, MODE_ENCODE = ck.MODE_DECODE, ck.MODE_ENCODE
FORCE_STAGED = 4  # the scan's staged path even where the rings fit (tests, chip_smoke.py)


# ---------------------------------------------------------------------------
# Host tables of the plain version: the cells of every step, per level
# ---------------------------------------------------------------------------

class PlaneLayer(NamedTuple):
    ptr: np.ndarray     # (T2+1,): cells of step t are cells[ptr[t]:ptr[t+1]]
    cells: np.ndarray   # (N,) int64 flat index in the level's grid
    taps: torch.Tensor  # (N, ntaps) int64 source in the level below (CPU)
    skip: Optional[np.ndarray]  # (N,) level-1 flat index (layer 3 only)


@functools.lru_cache(maxsize=8)
def plane_layers(latent_shape: Tuple[int, int, int], K: int) -> Tuple[PlaneLayer, ...]:
    sched = planar.build_planar_schedule(latent_shape, K)
    BH, CTR, grids = sched.BH, sched.CTR, sched.grids
    out = []
    for l in range(1, planar.NUM_LAYERS + 1):
        Hl, Wl = grids[l]
        Ws = grids[l - 1][1]
        h, w = np.meshgrid(np.arange(Hl), np.arange(Wl), indexing='ij')
        h, w = h.reshape(-1), w.reshape(-1)
        t = BH * h + w + CTR * l
        order = np.argsort(t, kind='stable')
        h, w, t = h[order], w[order], t[order]
        assert t.max() < sched.T2
        ptr = np.searchsorted(t, np.arange(sched.T2 + 1))
        taps = np.stack([(h + dy) * Ws + (w + dx) for dy, dx in sched.taps[l - 1]], 1)
        skip = (h + K - 1) * grids[1][1] + (w + K - 1) if l == 3 else None
        out.append(PlaneLayer(ptr=ptr, cells=h * Wl + w,
                              taps=torch.from_numpy(taps.astype(np.int64)), skip=skip))
    return tuple(out)


class PlaneWeights(NamedTuple):
    """Top-slice weights of the four layers, each (ntaps, cin, cout) over
    the schedule's unmasked taps in (dy, dx) order; the pad value (1,);
    the centers (L,). All float32, on one device."""
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    w4: torch.Tensor
    pad: torch.Tensor
    centers: torch.Tensor

    def packed(self) -> torch.Tensor:
        return torch.cat([a.reshape(-1).float() for a in self]).contiguous()


class PlaneOut(NamedTuple):
    acts: Tuple[torch.Tensor, ...]       # levels 1..3, each (B, Hl, Wl, kf)
    q: torch.Tensor                      # (B, H0, W0) padded q plane
    fsel: Optional[torch.Tensor] = None  # encode: (B, T2, R) int32
    ssel: Optional[torch.Tensor] = None
    syms: Optional[torch.Tensor] = None  # decode: (B, H, W) int32
    states: Optional[torch.Tensor] = None  # decode: (B, R) int32 (uint32 bits)
    gptr: Optional[torch.Tensor] = None    # decode: (B,) int32 read pointer


def _q_index(sched: planar.PlanarSchedule) -> np.ndarray:
    """(H*W,) flat level-0 index of every latent cell."""
    _, H, W = sched.latent_shape
    reach = planar.geometry(sched.K)[1]
    W0 = sched.grids[0][1]
    h, w = np.meshgrid(np.arange(H), np.arange(W), indexing='ij')
    return ((h + reach) * W0 + (w + reach)).reshape(-1)


# ---------------------------------------------------------------------------
# Kernel 5: one plane's wavefront (encode / decode)
# ---------------------------------------------------------------------------

def plane_forward_plain(mode: int, weights: PlaneWeights,
                        latent_shape: Tuple[int, int, int], K: int, bias, *,
                        true_plane=None, streams=None, states=None, gptr=None,
                        thresh=None, return_logits: bool = False) -> PlaneOut:
    """Plain PyTorch version of kernel 5: a Python loop over the T2 steps,
    vectorised over the step's cells and the batch, in the kernel's layer
    order and roundings.

    bias: the plane's 4 bias rows (B, Hl, Wl, cout) f32 for levels 1..4.
    encode (mode 1): true_plane (B, H, W) int -> PlaneOut with fsel/ssel.
    decode (mode 0): streams (B, cap) int32 words, states (B, R) int32
    (uint32 bits) and gptr (B,) int32 at the plane's start, thresh (B, R)
    the plane's pull threshold -> PlaneOut with syms, states, gptr.
    ``return_logits`` also returns the plane's (B, H*W, L) logits."""
    sched = planar.build_planar_schedule(latent_shape, K)
    layers = plane_layers(sched.latent_shape, K)
    dev = weights.w1.device
    _, H, W = sched.latent_shape
    HW = H * W
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    B = bias[0].shape[0]
    f32 = torch.float32
    H0, W0 = sched.grids[0]
    q = torch.full((B, H0 * W0, 1), float(weights.pad), dtype=f32, device=dev)
    acts = [torch.empty(B, g[0] * g[1], kf, dtype=f32, device=dev)
            for g in sched.grids[1:4]]
    logits = torch.empty(B, HW, L, dtype=f32, device=dev)
    bias_flat = [b.reshape(B, -1, b.shape[-1]) for b in bias]
    taps = [ly.taps.to(dev) for ly in layers]
    cells_all = [torch.from_numpy(ly.cells).to(dev) for ly in layers]
    skip = torch.from_numpy(layers[2].skip).to(dev)
    ws = (weights.w1, weights.w2, weights.w3, weights.w4)
    q_idx = torch.from_numpy(_q_index(sched)).to(dev)
    idx_cm = torch.from_numpy(sched.idx_cm.astype(np.int64)).to(dev)
    act_cm = sched.idx_cm < HW
    act_dev = torch.from_numpy(act_cm).to(dev)
    if mode == MODE_ENCODE:
        fsel = torch.zeros(B, sched.T2, R, dtype=torch.int32, device=dev)
        ssel = torch.zeros_like(fsel)
        true_l = true_plane.reshape(B, HW).long()
    else:
        syms = torch.zeros(B, HW, dtype=torch.int32, device=dev)
        st = states.long() & rans.MASK32
        gp = gptr.long()
        cnt = torch.zeros(B, R, dtype=torch.long, device=dev)
        thr = thresh.long()
        stream_l = streams.long()
    for t in range(sched.T2):
        src = q
        for li, ly in enumerate(layers):
            a, b = ly.ptr[t], ly.ptr[t + 1]
            if a < b:
                cells = cells_all[li][a:b]
                y = ck._layer_step(src, taps[li][a:b], ws[li], bias_flat[li][:, cells])
                if li == 2:
                    y = y + acts[0][:, skip[a:b]]
                else:
                    y = torch.relu(y)
                (acts[li] if li < 3 else logits)[:, cells] = y
            if li < 3:
                src = acts[li]
        if not act_cm[t].any():
            continue
        act = act_dev[t]
        idx = torch.clamp(idx_cm[t], max=HW - 1)
        live = idx[act]
        fq, cl = ck.logits_to_cdf(logits[:, idx])           # (B, R, L)
        if mode == MODE_ENCODE:
            sym = torch.where(act, true_l[:, idx], 0)
            fs = torch.gather(fq, -1, sym[..., None])[..., 0]
            ss = torch.gather(cl, -1, sym[..., None])[..., 0]
            fsel[:, t] = torch.where(act, fs, 0).int()
            ssel[:, t] = torch.where(act, ss, 0).int()
        else:
            sym, st, gp, cnt = rans.decode_step_interleaved(
                st, gp, stream_l, fq, cl, act[None].expand(B, R), cnt, thr)
            syms[:, live] = sym[:, act].int()
        q[:, q_idx[live], 0] = weights.centers[sym[:, act]]
    acts = tuple(a.reshape(B, g[0], g[1], kf) for a, g in zip(acts, sched.grids[1:4]))
    qp = q.reshape(B, H0, W0)
    if mode == MODE_ENCODE:
        out = PlaneOut(acts, qp, fsel=fsel, ssel=ssel)
    else:
        out = PlaneOut(acts, qp, syms=syms.reshape(B, H, W),
                       states=ck.to_int32_bits(st), gptr=gp.int())
    return (out, logits) if return_logits else out


class _PlaneArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in (
        'mode', 'B', 'H', 'W', 'K', 'BH', 'CTR', 'T2', 'kf', 'L', 'cap', 'threads',
        'level', 'force', 'rslot')]
                + [('nt', ctypes.c_int * 4),
                   ('tdy', (ctypes.c_int * MAX_TAPS) * 4),
                   ('tdx', (ctypes.c_int * MAX_TAPS) * 4)]
                + [(k, ctypes.c_void_p) for k in (
                    'params', 'bias1', 'bias2', 'bias3', 'bias4', 'act1', 'act2',
                    'act3', 'qplane', 'logits', 'idx_cm', 'true_plane', 'fsel', 'ssel', 'streams',
                    'states_in', 'gptr_in', 'thresh', 'syms_out', 'states_out',
                    'gptr_out', 'prof')])


_PLANE_ARGTYPES = (_PlaneArgs, ctypes.c_void_p)     # (arguments, stream)


def _plane_args(weights: PlaneWeights, sched: planar.PlanarSchedule, pairs: int,
                **fields) -> '_PlaneArgs':
    """The C argument struct for ``pairs`` planes (images in the scan, (image,
    plane) pairs in the layer-parallel encode): geometry, tap offsets, packed
    weights; ``fields`` are tensors (passed as pointers) or ints."""
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    if not 2 <= L <= MAX_L:
        raise ValueError(f'num_centers must be in [2, {MAX_L}], got {L}')
    if max(len(tp) for tp in sched.taps) > MAX_TAPS:
        raise ValueError(f'kernel_size {sched.K} has more than {MAX_TAPS} taps per layer')
    _, H, W = sched.latent_shape
    params = weights.packed()
    a = _PlaneArgs(B=pairs, H=H, W=W, K=sched.K, BH=sched.BH, CTR=sched.CTR,
                   T2=sched.T2, kf=kf, L=L, cap=1, threads=32, level=0,
                   params=build.ptr(params))
    a._keep = [params]       # the struct holds raw pointers: keep the owners
    for k, v in fields.items():
        if isinstance(v, torch.Tensor):
            a._keep.append(v)
            v = build.ptr(v)
        setattr(a, k, v)
    for l, tp in enumerate(sched.taps):
        a.nt[l] = len(tp)
        for k, (dy, dx) in enumerate(tp):
            a.tdy[l][k] = dy
            a.tdx[l][k] = dx
    return a


# ---------------------------------------------------------------------------
# Kernel 5's scan: the ring path's geometry and where it runs
# ---------------------------------------------------------------------------

class RingGeometry(NamedTuple):
    """The scan's rings (csrc/plane_forward.cu): levels 0-3 each keep their
    last ``depth`` = CTR + 1 diagonals, ``slots`` cells a diagonal (the
    kernel's PlaneArgs::rslot), cell (h, diagonal v) in ring_slot(v, h)."""
    depth: int
    slots: int

    def slot(self, v, h):
        """The slot of cell (h, diagonal v) of a level (ints or arrays)."""
        return (v % self.depth) * self.slots + h % self.slots


def diagonal_cells(sched: planar.PlanarSchedule, level: int) -> int:
    """The most cells a diagonal of level ``level`` has (its grid's height,
    or one cell in every BH columns)."""
    Hl, Wl = sched.grids[level]
    return min(Hl, -(-Wl // sched.BH))


def ring_geometry(sched: planar.PlanarSchedule) -> RingGeometry:
    """A slot for every cell of a diagonal of levels 0-3, and more than the
    K // 2 rows below a cell that its taps reach."""
    return RingGeometry(sched.CTR + 1, max([sched.K // 2 + 1]
                                           + [diagonal_cells(sched, l) for l in range(4)]))


def ring_bytes(geom: RingGeometry, kf: int, n_params: int) -> int:
    """The ring path's dynamic shared memory: the packed weights, then the
    rings of level 0 (a float a cell) and levels 1-3 (kf floats), each start
    on a float4."""
    return 4 * (ck._round_up(n_params, 4) + ck._round_up(geom.depth * geom.slots, 4)
                + 3 * geom.depth * geom.slots * kf)


def scan_threads(sched: planar.PlanarSchedule, kf: int) -> int:
    """The scan's block: a thread for each (cell, channel) of the widest band
    a step has, within 64..512."""
    band = max(-(-g[1] // sched.BH) for g in sched.grids[1:])
    return min(512, max(64, ck._round_up(min(band, R) * kf, 32)))


def ring_fits(sched: planar.PlanarSchedule, kf: int, L: int, n_params: int, room: int,
              force: int = 0) -> bool:
    """Whether kernel 5's scan takes the ring path: the compile-time
    instance (K = 5, kf = 24, L = 6, 12 / 13 taps) with its weights in shared
    memory, a thread for every (cell, channel) of a band, and the weights and
    rings within ``room`` bytes (plane_ring_room: the card's opt-in limit less
    the kernel's static shared memory). ``force`` (any bit) takes the staged
    path."""
    if (force or (sched.K, kf, L) != (5, 24, 6)
            or [len(tp) for tp in sched.taps] != [12, 13, 13, 13]):
        return False
    threads = scan_threads(sched, kf)
    if any(diagonal_cells(sched, l) * (L if l == 4 else kf) > threads for l in range(1, 5)):
        return False
    return ring_bytes(ring_geometry(sched), kf, n_params) <= room


@functools.lru_cache(maxsize=32)
def _scan_rslot(latent_shape, K: int, kf: int, L: int, n_params: int, index: int,
                force: int) -> int:
    """PlaneArgs::rslot of a scan on card ``index``: the ring path's slots, or
    0 (the staged path)."""
    with torch.cuda.device(index):
        room = build.entry('plane_forward', 'plane_ring_room', ())()
    if room < 0:
        raise RuntimeError(f'plane_ring_room: cudaError {-room}')
    sched = planar.build_planar_schedule(latent_shape, K)
    return ring_geometry(sched).slots if ring_fits(sched, kf, L, n_params, room, force) else 0


def _launch(entry: str, a: '_PlaneArgs', dev) -> None:
    fn = build.entry('plane_forward', entry, _PLANE_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(a, build.stream_ptr(dev))
    build.check(err, entry)


def plane_forward(mode: int, weights: PlaneWeights,
                  latent_shape: Tuple[int, int, int], K: int, bias, *,
                  true_plane=None, streams=None, states=None, gptr=None,
                  thresh=None, prof=None, force: int = 0) -> PlaneOut:
    """Kernel 5's scan over one plane. Same contract as plane_forward_plain
    (without return_logits); a CPU tensor runs the plain version, a CUDA
    tensor launches csrc/plane_forward.cu. Mode 1 is the consistency oracle
    of the layer-parallel encode (level_forward + plane_tables). ``prof``
    (B, 5) int64 on the device receives thread 0's clocks in levels 1-4 and
    in the CDF + rANS part, summed over the steps. ``force`` as in
    cuda_kernel.wavefront_forward (the same bits), or FORCE_STAGED. The scan
    takes the ring path where ring_fits (counted by
    ``build.LAUNCHES['plane_ring']``), else the staged path: the same bits."""
    if mode not in (MODE_DECODE, MODE_ENCODE):
        raise ValueError(f'mode must be 0 (decode) or 1 (encode), got {mode}')
    dev = weights.w1.device
    if dev.type == 'cpu':
        return plane_forward_plain(mode, weights, latent_shape, K, bias,
                                   true_plane=true_plane, streams=streams,
                                   states=states, gptr=gptr, thresh=thresh)
    if dev.type != 'cuda':
        raise ValueError(f'plane_forward: unsupported device {dev}')
    sched = planar.build_planar_schedule(latent_shape, K)
    _, H, W = sched.latent_shape
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    f32, i32 = torch.float32, torch.int32
    B = bias[0].shape[0]
    for l, b in enumerate(bias):
        g = sched.grids[l + 1]
        ck._check_cuda(f'bias{l + 1}', b, f32, (B, g[0], g[1], L if l == 3 else kf), dev)
    dummy = torch.zeros(1, dtype=i32, device=dev)
    if mode == MODE_ENCODE:
        ck._check_cuda('true_plane', true_plane, i32, (B, H, W), dev)
        fsel = torch.empty(B, sched.T2, R, dtype=i32, device=dev)
        ssel = torch.empty_like(fsel)
        streams = states = gptr = thresh = syms = states_out = gptr_out = dummy
        cap = 1
    else:
        cap = streams.shape[1]
        ck._check_cuda('streams', streams, i32, (B, cap), dev)
        ck._check_cuda('states', states, i32, (B, R), dev)
        ck._check_cuda('gptr', gptr, i32, (B,), dev)
        ck._check_cuda('thresh', thresh, i32, (B, R), dev)
        syms = torch.empty(B, H, W, dtype=i32, device=dev)
        states_out = torch.empty(B, R, dtype=i32, device=dev)
        gptr_out = torch.empty(B, dtype=i32, device=dev)
        true_plane = fsel = ssel = dummy
    acts = [torch.empty(B, g[0], g[1], kf, dtype=f32, device=dev)
            for g in sched.grids[1:4]]
    qp = torch.empty(B, *sched.grids[0], dtype=f32, device=dev)
    rslot = _scan_rslot(sched.latent_shape, K, kf, L, sum(w.numel() for w in weights),
                        dev.index, force)
    a = _plane_args(weights, sched, B, mode=mode, cap=cap, threads=scan_threads(sched, kf),
                    force=force, rslot=rslot,
                    bias1=bias[0], bias2=bias[1], bias3=bias[2], bias4=bias[3],
                    act1=acts[0], act2=acts[1], act3=acts[2], qplane=qp,
                    true_plane=true_plane, fsel=fsel, ssel=ssel, streams=streams,
                    states_in=states, gptr_in=gptr, thresh=thresh, syms_out=syms,
                    states_out=states_out, gptr_out=gptr_out,
                    **({} if prof is None else {'prof': prof}))
    _launch('plane_forward', a, dev)
    build.LAUNCHES['plane_forward_encode_scan' if mode == MODE_ENCODE
                   else 'plane_forward_decode'] += 1
    if rslot:
        build.LAUNCHES['plane_ring'] += 1
    acts = tuple(acts)
    if mode == MODE_ENCODE:
        return PlaneOut(acts, qp, fsel=fsel, ssel=ssel)
    return PlaneOut(acts, qp, syms=syms, states=states_out, gptr=gptr_out)


# ---------------------------------------------------------------------------
# Kernel 5, layer-parallel encode: one level of every (image, plane) pair
# ---------------------------------------------------------------------------

def level_forward_plain(level: int, weights: PlaneWeights,
                        latent_shape: Tuple[int, int, int], K: int,
                        src: torch.Tensor, bias: torch.Tensor,
                        skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of level_forward: every cell of the level
    through _layer_step (each output the same chain of roundings as in the
    step-ordered plain version), then the bias row, level 3's skip, ReLU."""
    layer = plane_layers(tuple(int(v) for v in latent_shape), K)[level - 1]
    P = src.shape[0]
    cout = bias.shape[-1]
    cells = torch.from_numpy(layer.cells).to(src.device)
    y = ck.layer_all_cells(src.reshape(P, -1, 1 if level == 1 else src.shape[-1]),
                           layer.taps.to(src.device),
                           (weights.w1, weights.w2, weights.w3, weights.w4)[level - 1],
                           bias.reshape(P, -1, cout)[:, cells])
    if level == 3:
        y = y + skip.reshape(P, -1, cout)[:, torch.from_numpy(layer.skip).to(src.device)]
    else:
        y = torch.relu(y)
    out = torch.empty_like(y)
    out[:, cells] = y
    return out.reshape(bias.shape)


def level_forward(level: int, weights: PlaneWeights,
                  latent_shape: Tuple[int, int, int], K: int, src: torch.Tensor,
                  bias: torch.Tensor, skip: Optional[torch.Tensor] = None,
                  force: int = 0) -> torch.Tensor:
    """Kernel 5's layer-parallel encode pass: level ``level`` (1..4) of P
    (image, plane) pairs in one launch. src (P, H_{l-1}, W_{l-1}[, kf]) is
    the level below (level 0: the padded q planes), bias (P, H_l, W_l, cout)
    the level's bias rows, skip (level 3 only) the level-1 activations ->
    (P, H_l, W_l, cout) f32 (level 4: the ReLU'd logits). A CPU tensor runs
    the plain version, a CUDA tensor launches csrc/plane_forward.cu (``force``
    as in plane_forward)."""
    if level not in (1, 2, 3, 4) or (level == 3) != (skip is not None):
        raise ValueError(f'level {level} with skip {"given" if skip is not None else "absent"}')
    dev = weights.w1.device
    if dev.type == 'cpu':
        return level_forward_plain(level, weights, latent_shape, K, src, bias, skip)
    if dev.type != 'cuda':
        raise ValueError(f'level_forward: unsupported device {dev}')
    sched = planar.build_planar_schedule(latent_shape, K)
    kf, L = weights.w1.shape[-1], weights.w4.shape[-1]
    P = src.shape[0]
    f32 = torch.float32
    gs, gl = sched.grids[level - 1], sched.grids[level]
    ck._check_cuda('src', src, f32, (P,) + gs + (() if level == 1 else (kf,)), dev)
    ck._check_cuda('bias', bias, f32, (P,) + gl + (L if level == 4 else kf,), dev)
    if skip is not None:
        ck._check_cuda('skip', skip, f32, (P,) + sched.grids[1] + (kf,), dev)
    out = torch.empty_like(bias)
    names = ('qplane', 'act1', 'act2', 'act3', 'logits')
    fields = {names[level - 1]: src, names[level]: out, f'bias{level}': bias}
    if skip is not None:
        fields['act1'] = skip
    _launch('plane_level', _plane_args(weights, sched, P, level=level, force=force, **fields),
            dev)
    build.LAUNCHES['plane_forward_encode'] += 1
    return out


def weights_in_device(weights: PlaneWeights, latent_shape: Tuple[int, int, int], K: int,
                      scan: bool = True, force: int = 0) -> bool:
    """Whether kernel 5's scan (or, without ``scan``, its level passes)
    reads the weights from device memory at these widths: they do not fit in
    a block's shared memory (kf >= ~46 at K = 5, L = 6), or ``force`` asks
    for it."""
    sched = planar.build_planar_schedule(latent_shape, K)
    fn = build.entry('plane_forward', 'plane_weights_in_device', (_PlaneArgs, ctypes.c_int))
    out = fn(_plane_args(weights, sched, 1, force=force), int(scan))
    if out < 0:
        raise RuntimeError(f'plane_weights_in_device: cudaError {-out}')
    return bool(out)


def plane_tables_plain(logits: torch.Tensor, true_planes: torch.Tensor,
                       latent_shape: Tuple[int, int, int], K: int):
    """Plain PyTorch version of plane_tables (same contract)."""
    sched = planar.build_planar_schedule(latent_shape, K)
    idx_cm = torch.from_numpy(sched.idx_cm.astype(np.int64)).to(logits.device)
    P = logits.shape[0]
    return ck.tables_from_logits(logits.reshape(P, -1, logits.shape[-1]), idx_cm,
                                 true_planes.reshape(P, -1))


@functools.lru_cache(maxsize=8)
def _plane_idx_cm(latent_shape, K: int, device: str) -> torch.Tensor:
    sched = planar.build_planar_schedule(latent_shape, K)
    return torch.from_numpy(np.ascontiguousarray(sched.idx_cm, np.int32)).to(device)


def plane_tables(weights: PlaneWeights, logits: torch.Tensor, true_planes: torch.Tensor,
                 latent_shape: Tuple[int, int, int], K: int):
    """Kernel 5's table pass: logits (P, H, W, L) of P (image, plane) pairs
    and their true symbols (P, H, W) int32 -> (fsel, ssel) (P, T2, R) int32,
    0 on dead lanes. Plain version on the CPU, csrc/plane_forward.cu on CUDA."""
    dev = logits.device
    if dev.type == 'cpu':
        return plane_tables_plain(logits, true_planes, latent_shape, K)
    if dev.type != 'cuda':
        raise ValueError(f'plane_tables: unsupported device {dev}')
    sched = planar.build_planar_schedule(latent_shape, K)
    _, H, W = sched.latent_shape
    P, L = logits.shape[0], logits.shape[-1]
    ck._check_cuda('logits', logits, torch.float32, (P, H, W, L), dev)
    ck._check_cuda('true_planes', true_planes, torch.int32, (P, H, W), dev)
    fsel = torch.empty(P, sched.T2, R, dtype=torch.int32, device=dev)
    ssel = torch.empty_like(fsel)
    a = _plane_args(weights, sched, P, logits=logits, true_plane=true_planes,
                    idx_cm=_plane_idx_cm(sched.latent_shape, K, str(dev)),
                    fsel=fsel, ssel=ssel)
    _launch('plane_tables', a, dev)
    build.LAUNCHES['plane_forward_encode'] += 1
    return fsel, ssel


# ---------------------------------------------------------------------------
# Kernel 6: reverse interleaved rANS over the (plane, step) rows
# ---------------------------------------------------------------------------

def _full_active(sched: planar.PlanarSchedule) -> np.ndarray:
    """(C * T2, R) bool activity of every (plane, step) row in coding order."""
    C = sched.latent_shape[0]
    return np.tile(sched.idx_cm < sched.latent_shape[1] * sched.latent_shape[2], (C, 1))


@functools.lru_cache(maxsize=8)
def _device_reverse_list(latent_shape, K: int, device: str) -> ck.ReverseList:
    return ck.reverse_list_to(_full_active(planar.build_planar_schedule(latent_shape, K)),
                              device)


def plane_reverse_plain(fsel: torch.Tensor, ssel: torch.Tensor,
                        latent_shape: Tuple[int, int, int], K: int,
                        x0: int = rans.RANS_L):
    """Plain version of kernel 6: fsel/ssel (B, C*T2, R) int32 in (plane,
    step) coding order -> (words (B, cap), n_words (B,), states (B, R), k
    (B, R)) as ck.reverse_plain_list; within a step words go in descending
    lane rank, and the warmup counts k are taken before the renormalisation."""
    sched = planar.build_planar_schedule(latent_shape, K)
    return ck.reverse_plain_list(fsel, ssel, *ck.reverse_list(_full_active(sched)),
                                 sched.stream_cap, x0)


def plane_reverse(fsel: torch.Tensor, ssel: torch.Tensor,
                  latent_shape: Tuple[int, int, int], K: int,
                  x0: int = rans.RANS_L, prof: Optional[torch.Tensor] = None):
    """Kernel 6 wrapper; same contract as plane_reverse_plain. ``prof`` as in
    ck.reverse_launch (CUDA only)."""
    if not 1 <= x0 <= rans.RANS_L:
        raise ValueError(f'x0 must be in [1, RANS_L], got {x0}')
    if fsel.device.type == 'cpu':
        return plane_reverse_plain(fsel, ssel, latent_shape, K, x0)
    if fsel.device.type != 'cuda':
        raise ValueError(f'plane_reverse: unsupported device {fsel.device}')
    sched = planar.build_planar_schedule(latent_shape, K)
    rlist = _device_reverse_list(sched.latent_shape, K, str(fsel.device))
    out = ck.reverse_launch(fsel, ssel, rlist, sched.stream_cap, x0, prof)
    build.LAUNCHES['plane_reverse'] += 1
    return out
