"""The planar codec's bias rows: the lower kernel slices of each context
layer over the kd-1 known planes below the one being coded, plus the
layer's bias (coding/planar.py's depth decomposition). Kernel 5 adds the
current plane's top-slice taps to them.

Two layouts of one function, as PlanarCoder needs them:

- ``level_rows`` (the encode): level l of all B x C (image, plane) pairs
  from level l-1 of all of them, (B*C, H_{l-1}, W_{l-1}[, cin]) ->
  (B*C, H_l, W_l, cout); one call a level, 4 a batch.
- ``plane_rows`` (the decode): levels 1..4 of one plane of B images from a
  ``History`` of the kd-1 planes below it -> four (B, H_l, W_l, cout); one
  call a plane, C a batch.

Planes below 0 are the all-pad constants (the pad value for q, k1..k3 for
the hidden layers). On a CUDA tensor each call is one launch of
csrc/bias_rows.cu, whose every output is one fixed chain of fmaf over (j,
dy, dx, ci) and then the bias: the rows of an image do not depend on the
batch or the layout. On a CPU tensor the plain versions run: one F.conv2d a
(image, plane) on the same contiguous (1, (kd-1) cin, H, W) input in both
layouts, so they too are batch-invariant and agree bit for bit. Each launch
adds one to ``build.LAUNCHES['bias_rows']`` (4 + C a round trip on the
card); the plain versions launch nothing and count nothing.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import build
from . import cuda_kernel as ck

MAX_J = 3             # kd - 1 planes below (K <= 7)


class History(NamedTuple):
    """The kd-1 planes below the one the decode codes next, per level
    0..3, oldest first: (b, H, W) (level 0, the padded q planes) or (b, H,
    W, kf), or None below plane 0 (the all-pad constants)."""
    b: int
    grids: Tuple[Tuple[int, int], ...]     # levels 0..3
    planes: List[List[Optional[torch.Tensor]]]


def history(b: int, grids, kd: int) -> History:
    """The history before plane 0: every plane below is a constant."""
    return History(b, tuple(tuple(g) for g in grids[:4]), [[None] * (kd - 1) for _ in range(4)])


def push(hist: History, q: torch.Tensor, acts: Sequence[torch.Tensor]) -> None:
    """Append a coded plane (its padded q plane and level 1-3 activations)
    and drop the oldest."""
    for h, n in zip(hist.planes, [q] + list(acts)):
        h.pop(0)
        h.append(n)


def _widths(fold, level: int) -> Tuple[int, int, int, int]:
    """(kd - 1, K, cin, cout) of ``level``'s lower slices."""
    kd1, K, _, cin, cout = fold.low[level - 1].shape
    return kd1, K, cin, cout


def _const(fold, level: int) -> torch.Tensor:
    """(cin,) value of level ``level - 1``'s planes below plane 0."""
    return fold.top.pad if level == 1 else fold.consts[level - 2]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.dim() == 3 else x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Plain versions (the wrappers' path for CPU tensors)
# ---------------------------------------------------------------------------

def conv_weight(fold, level: int) -> torch.Tensor:
    """``level``'s lower slices as one F.conv2d weight over the kd-1 planes
    stacked on channels, oldest first: (cout, (kd-1) cin, K, K)."""
    kd1, K, cin, cout = _widths(fold, level)
    return fold.low[level - 1].permute(4, 0, 3, 1, 2).reshape(cout, kd1 * cin, K, K)


def _rows_plain(fold, level: int, stacks: torch.Tensor) -> torch.Tensor:
    """stacks (n, kd-1, cin, H, W), each image's contiguous -> (n, H_l,
    W_l, cout): one F.conv2d an image."""
    n, kd1, cin, H, W = stacks.shape
    w = conv_weight(fold, level)
    y = torch.cat([F.conv2d(stacks[i].reshape(1, kd1 * cin, H, W), w, fold.bias[level - 1])
                   for i in range(n)])
    return y.permute(0, 2, 3, 1)


def level_rows_plain(fold, level: int, below: torch.Tensor, C: int) -> torch.Tensor:
    """Plain version of level_rows: each (image, plane) on the contiguous
    stack of its kd-1 planes below, oldest first."""
    kd1, _, cin, _ = _widths(fold, level)
    P = below.shape[0]
    b, gs = P // C, tuple(below.shape[1:3])
    vol = torch.cat([_const(fold, level)[None, None, :, None, None].expand(b, kd1, cin, *gs),
                     _nchw(below).reshape(b, C, cin, *gs)], 1)
    rows = torch.stack([_rows_plain(fold, level, vol[:, d:d + kd1]) for d in range(C)], 1)
    return rows.reshape(P, *rows.shape[2:]).contiguous()


def plane_rows_plain(fold, hist: History) -> Tuple[torch.Tensor, ...]:
    """Plain version of plane_rows: per level each image on the contiguous
    stack of the kd-1 planes below, oldest first."""
    rows = []
    for level in range(1, 5):
        _, _, cin, _ = _widths(fold, level)
        gs = hist.grids[level - 1]
        k = _const(fold, level)
        # Contiguous NCHW, as the encode layout's input (a stack of permuted
        # views would come out channels-last: another oneDNN path, other bits).
        x = torch.stack([k[None, :, None, None].expand(hist.b, cin, *gs) if p is None
                         else _nchw(p) for p in hist.planes[level - 1]], 1).contiguous()
        rows.append(_rows_plain(fold, level, x).contiguous())
    return tuple(rows)


# ---------------------------------------------------------------------------
# The kernel (csrc/bias_rows.cu)
# ---------------------------------------------------------------------------

class _Level(ctypes.Structure):
    _fields_ = ([('src', ctypes.c_void_p * MAX_J), ('off', ctypes.c_longlong * MAX_J),
                 ('src_img', ctypes.c_longlong), ('src_plane', ctypes.c_longlong)]
                + [(k, ctypes.c_void_p) for k in ('cval', 'w', 'bias', 'out')]
                + [('out_img', ctypes.c_longlong), ('out_plane', ctypes.c_longlong)]
                + [(k, ctypes.c_int) for k in ('level', 'nconst', 'Hs', 'Ws', 'Hl', 'Wl',
                                               'cin', 'cout', 'tiles', 'block0')])


class _Args(ctypes.Structure):
    _fields_ = ([('lv', _Level * 4)]
                + [(k, ctypes.c_int) for k in ('nlev', 'B', 'D', 'K', 'kd1', 'force')])


_ARGTYPES = (_Args, ctypes.c_void_p)     # (arguments, stream)


def _level(fold, level: int, srcs, offs, src_img: int, src_plane: int, nconst: int,
           out: torch.Tensor, out_img: int, out_plane: int) -> _Level:
    """One level's descriptor (csrc/bias_rows.cu's BiasLevel). It holds raw
    pointers: the caller keeps every tensor alive through the launch call."""
    _, K, cin, cout = _widths(fold, level)
    Hl, Wl = out.shape[1:3]
    tensors = (_const(fold, level), fold.low[level - 1], fold.bias[level - 1], out)
    lv = _Level(src_img=src_img, src_plane=src_plane, level=level, nconst=nconst,
                Hs=Hl + K - 1, Ws=Wl + K - 1, Hl=Hl, Wl=Wl, cin=cin, cout=cout,
                **{k: t.data_ptr() for k, t in zip(('cval', 'w', 'bias', 'out'), tensors)},
                out_img=out_img, out_plane=out_plane)
    for j, (s, o) in enumerate(zip(srcs, offs)):
        lv.src[j] = None if s is None else s.data_ptr()
        lv.off[j] = o
    return lv


def _launch(fold, levels: Sequence[_Level], B: int, D: int, force: int) -> None:
    kd1, K = _widths(fold, 1)[:2]
    a = _Args(nlev=len(levels), B=B, D=D, K=K, kd1=kd1, force=force)
    for v, lv in enumerate(levels):
        a.lv[v] = lv
    fn = build.entry('bias_rows', 'bias_rows', _ARGTYPES)
    dev = fold.low[0].device
    with build.on_device(dev):
        err = fn(a, build.stream_ptr(dev))
    build.check(err, 'bias_rows')
    build.LAUNCHES['bias_rows'] += 1


def _check_src(name: str, x: torch.Tensor, fold, level: int, lead: Tuple[int, ...], dev):
    _, _, cin, _ = _widths(fold, level)
    ck._check_cuda(name, x, torch.float32, lead + (() if level == 1 else (cin,)), dev)
    if x.data_ptr() % 16:
        raise ValueError(f'{name}: the kernel reads it in 16-byte words; got an offset view')


def level_rows(fold, level: int, below: torch.Tensor, C: int, force: int = 0) -> torch.Tensor:
    """The encode's bias rows of level ``level`` (1..4) of B*C (image,
    plane) pairs, image-major: below (B*C, H_{l-1}, W_{l-1}[, cin]) float32
    is level l-1 of every pair (level 0: the padded q planes) ->
    (B*C, H_l, W_l, cout) float32. A CPU tensor runs the plain version, a
    CUDA tensor one launch of csrc/bias_rows.cu (``force`` =
    cuda_kernel.FORCE_GENERIC: its generic instance)."""
    if level not in (1, 2, 3, 4):
        raise ValueError(f'level_rows: level must be 1..4, got {level}')
    if below.device.type == 'cpu':
        return level_rows_plain(fold, level, below, C)
    if below.device.type != 'cuda':
        raise ValueError(f'level_rows: unsupported device {below.device}')
    kd1, K, _, cout = _widths(fold, level)
    P = below.shape[0]
    if C < 1 or P % C:
        raise ValueError(f'level_rows: {P} pairs are not whole images of {C} planes')
    gs = tuple(below.shape[1:3])
    dev = fold.low[0].device
    _check_src('below', below, fold, level, (P,) + gs, dev)
    out = torch.empty(P, gs[0] - K + 1, gs[1] - K + 1, cout, device=dev)
    plane, oplane = below[0].numel(), out[0].numel()
    lv = _level(fold, level, [below] * kd1, [j - kd1 for j in range(kd1)], C * plane, plane,
                kd1, out, C * oplane, oplane)
    _launch(fold, [lv], P // C, C, force)
    return out


def plane_rows(fold, hist: History, force: int = 0) -> Tuple[torch.Tensor, ...]:
    """The decode's bias rows of levels 1..4 of the next plane of
    ``hist.b`` images -> four (b, H_l, W_l, cout) float32. A CPU fold runs
    the plain version, a CUDA one one launch of csrc/bias_rows.cu for all
    four levels (``force`` as in level_rows)."""
    dev = fold.low[0].device
    if dev.type == 'cpu':
        return plane_rows_plain(fold, hist)
    if dev.type != 'cuda':
        raise ValueError(f'plane_rows: unsupported device {dev}')
    kd1, K = _widths(fold, 1)[:2]
    b, levels, outs = hist.b, {}, []
    for level in range(1, 5):
        planes = hist.planes[level - 1]
        nconst = sum(p is None for p in planes)
        if len(planes) != kd1 or any(p is None for p in planes[nconst:]):
            raise ValueError('plane_rows: the history holds kd-1 planes, the constants first')
        gs = hist.grids[level - 1]
        for j, p in enumerate(planes[nconst:]):
            _check_src(f'level {level - 1} plane {nconst + j}', p, fold, level, (b,) + gs, dev)
        out = torch.empty(b, gs[0] - K + 1, gs[1] - K + 1, _widths(fold, level)[3], device=dev)
        outs.append(out)
        plane = planes[-1][0].numel() if nconst < kd1 else 0
        levels[level] = _level(fold, level, planes, [0] * kd1, plane, 0, nconst, out,
                               out[0].numel(), 0)
    # The heavy levels first: the card's last blocks are then light ones.
    _launch(fold, [levels[lv] for lv in (2, 3, 4, 1)], b, 1, force)
    return tuple(outs)
