"""The XLA-style scan codecs of the JAX package, container impl id 7: the
``direct`` scan (counterpart of imgcomp_cvpr_tpu/coding/codec.py::
_direct_scan_fn), with ``cached`` (coding/cached.py) and ``ring``
(coding/ring.py) as the other two step schedules of the same codec.

A scan walks the steps of a wavefront schedule (coding/wavefront.py). Each
step computes the context model's logits at the step's M positions, turns
them into CDFs (cuda_kernel.logits_to_cdf), takes the true symbol (encode,
teacher-forced) or rANS-decodes it over the rANS lanes (R_LANES, one lane
per position below 64 positions), and writes the symbol's center into the
volume that later steps read. Encode then runs the interleaved reverse
encoder over the (T, M) tables.

The three schedules compute every context-model cell with the port's one
layer sum (cuda_kernel.layer_sum) over the unmasked taps in window order (a
masked tap is skipped, never multiplied by a zero weight), and a cell whose
linear step t' = a d + b h + w is negative, which sees only padding, holds
the layer's all-pad constant (cuda_codec.pad_constants, float64 rounded
once). So a cell has the same bits in every schedule and in kernel 2, the
three write the same container bytes, and their per-cell (freq, start)
tables are kernel 2's. They differ from impl 5 only in the stream layout.
``direct`` handles any kernel_size and decodes id 7 for a codec that is not
itself a scan; ``cached`` and ``ring`` are K=3 only.

Speed is not their purpose: they are schedule oracles. On a card every
layer sum is two launches (the products, then a cumsum over the rows), so a
step costs some tens of launches.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import probclass as pc_lib
from . import codec as codec_lib
from . import cuda_codec
from . import cuda_kernel as ck
from . import rans
from . import wavefront

MODE_DECODE, MODE_ENCODE = ck.MODE_DECODE, ck.MODE_ENCODE


def unmasked_taps(K: int, first: bool) -> Tuple[Tuple[int, int, int], ...]:
    """(dz, dy, dx) of the taps of a (kd, K, K) masked kernel whose weight is
    not masked out, in window (row-major) order."""
    kd = pc_lib.filter_depth(K)
    m = pc_lib.spatial_mask(K, first)
    return tuple((dz, dy, dx) for dz in range(kd) for dy in range(K) for dx in range(K)
                 if dz < kd - 1 or m[dy, dx] > 0)


class ScanWeights(NamedTuple):
    """The context model for the scans, float32 on the coder's device."""
    w: Tuple[torch.Tensor, ...]      # 4 x (ntaps * cin, cout), rows in layer_sum order
    b: Tuple[torch.Tensor, ...]      # 4 x (cout,)
    k: Tuple[torch.Tensor, ...]      # 3 x (kf,): all-pad activation of layers 1-3
    pad: float                       # the pad value (a float32 number)
    centers: torch.Tensor            # (L,)
    K: int


def fold_scan_weights(pc: pc_lib.ProbClassifier, centers: torch.Tensor) -> ScanWeights:
    net = pc.net
    K = net.kernel_size
    dev = centers.device
    ws, bs = [], []
    for i, conv in enumerate((net.conv0, net.res1.conv1, net.res1.conv2, net.conv_out)):
        w = conv.weight.detach().float()
        cols = [w[:, :, dz, dy, dx].t() for dz, dy, dx in unmasked_taps(K, i == 0)]
        ws.append(torch.stack(cols).reshape(-1, w.shape[0]).to(dev).contiguous())
        bs.append(conv.bias.detach().float().to(dev))
    pad = float(pc_lib.auto_pad_value(pc.config, centers, pc))
    k = tuple(c.float().to(dev) for c in cuda_codec.pad_constants(pc, pad))
    return ScanWeights(tuple(ws), tuple(bs), k, float(np.float32(pad)),
                       centers.detach().float().contiguous(), K)


@functools.lru_cache(maxsize=64)
def valid_taps(in_shape, K: int, first: bool) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """A VALID masked (kd, K, K) layer over a dense (D, H, W) grid: the
    (cells_out, ntaps) flat input index of each output cell's unmasked
    taps, in window order, and the output grid's shape."""
    p = K // 2
    D, H, W = in_shape
    out = (D - p, H - 2 * p, W - 2 * p)
    d, h, w = np.meshgrid(*(np.arange(n) for n in out), indexing='ij')
    cols = [((d + dz) * H + (h + dy)) * W + (w + dx) for dz, dy, dx in unmasked_taps(K, first)]
    return np.stack([c.reshape(-1) for c in cols], 1), out


def masked_layer(x: torch.Tensor, l: int, sw: ScanWeights, idx: torch.Tensor) -> torch.Tensor:
    """Layer l (1..4) of the context model over a dense grid: x (..., cells_in,
    cin), idx (cells_out, ntaps) from valid_taps -> (..., cells_out, cout),
    every cell a layer_sum over its unmasked taps; before the activation
    (and for layer 3 before the skip)."""
    g = x[..., idx, :]
    return ck.layer_sum(g.reshape(*g.shape[:-2], -1), sw.w[l - 1], sw.b[l - 1])


def cell_tables(fsel: torch.Tensor, index: np.ndarray, n: int) -> torch.Tensor:
    """(B, rows, cols) per-lane tables and the (rows, cols) latent index of
    each lane (>= n or < 0 on dead lanes) -> (B, n) per-cell tables."""
    idx = torch.from_numpy(np.asarray(index, np.int64).reshape(-1)).to(fsel.device)
    live = (idx >= 0) & (idx < n)
    out = torch.zeros(fsel.shape[0], n, dtype=fsel.dtype, device=fsel.device)
    out[:, idx[live]] = fsel.reshape(fsel.shape[0], -1)[:, live]
    return out


class ScanRun(NamedTuple):
    """What a scan builder makes for one latent shape: ``step_logits(state,
    t)`` -> (B, M, L) logits of step t; ``write(state, t, sym)`` stores step
    t's symbols (B, M) (dead lanes 0); ``init(sw, B)`` -> the state."""
    sched: wavefront.Schedule
    init: Callable
    step_logits: Callable
    write: Callable


def run_scan(run: ScanRun, sw: ScanWeights, mode: int, B: int, *, true_syms=None,
             streams=None, init_states=None, thresh=None):
    """The shared step of every scan: logits -> CDF -> the teacher-forced
    or rANS-decoded symbol -> write -> the symbol's (freq, start). Returns
    (syms, freq_sel, start_sel), each (B, T, M) int64 (0 on dead lanes).
    Decode takes streams (B, W), init_states (B, r) uint32 values and
    thresh (B, r), all int64."""
    sched = run.sched
    T, M = sched.T, sched.M
    dev = sw.centers.device
    r = rans.lanes(M)
    tabs = _sched_tables(sched, str(dev))
    state = run.init(sw, B)
    syms = torch.zeros(B, T, M, dtype=torch.long, device=dev)
    fsel, ssel = torch.zeros_like(syms), torch.zeros_like(syms)
    if mode == MODE_DECODE:
        states = init_states & rans.MASK32
        gptr = torch.zeros(B, dtype=torch.long, device=dev)
        cnt = torch.zeros(B, r, dtype=torch.long, device=dev)
    for t in range(T):
        act = tabs.active[t]
        freq, cdf = ck.logits_to_cdf(run.step_logits(state, t))
        if mode == MODE_ENCODE:
            sym = torch.where(act, true_syms[:, tabs.sym_flat[t]].long(), 0)
        else:
            parts = []
            for si in range(M // r):
                sl = slice(si * r, (si + 1) * r)
                s, states, gptr, cnt = rans.decode_step_interleaved(
                    states, gptr, streams, freq[:, sl], cdf[:, sl],
                    act[sl].expand(B, r), cnt, thresh)
                parts.append(s)
            sym = torch.cat(parts, 1)
        run.write(state, t, sym)
        syms[:, t] = sym
        fsel[:, t] = torch.where(act, torch.gather(freq, -1, sym[..., None])[..., 0], 0)
        ssel[:, t] = torch.where(act, torch.gather(cdf, -1, sym[..., None])[..., 0], 0)
    return syms, fsel, ssel


class SchedTables(NamedTuple):
    active: torch.Tensor      # (T, M) bool
    sym_flat: torch.Tensor    # (T, M) int64
    base_flat: torch.Tensor
    scatter_flat: torch.Tensor
    ctx_offsets: torch.Tensor
    t_lin: torch.Tensor       # (T, M) int64 linear step of each position


_TABLES = {}


def _sched_tables(sched: wavefront.Schedule, device: str) -> SchedTables:
    """The schedule's index arrays on ``device``, uploaded once (keyed by the
    schedule object, which wavefront.build_schedule caches)."""
    key = (id(sched), device)
    if key not in _TABLES:
        def t(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        a, b, c = wavefront.wavefront_coeffs(sched.pad)
        pos = sched.positions.astype(np.int64)
        t_lin = a * pos[..., 0] + b * pos[..., 1] + c * pos[..., 2]
        _TABLES[key] = (sched, SchedTables(
            torch.from_numpy(sched.active).to(device), t(sched.sym_flat),
            t(sched.base_flat), t(sched.scatter_flat), t(sched.ctx_offsets), t(t_lin)))
    return _TABLES[key][1]


# ---------------------------------------------------------------------------
# direct: full context patches every step
# ---------------------------------------------------------------------------

class DirectScanBuilder:
    """Per step: gather each position's (ctx_d, cs, cs) patch of the padded
    volume at base + ctx_offsets, run the four masked layers over it (cells
    with t' < 0 hold their all-pad constant), and scatter the symbols'
    centers back (codec.py:234-291 of the JAX package). Any kernel_size."""

    def __init__(self, pc_config):
        self.K = pc_config.kernel_size
        self.cs = pc_lib.context_size(pc_config)

    def make_run(self, latent_shape: Tuple[int, int, int]) -> ScanRun:
        sched = wavefront.build_schedule(tuple(latent_shape), self.cs)
        K, cs, pad = self.K, self.cs, sched.pad
        p = K // 2
        a, b, c = wavefront.wavefront_coeffs(pad)
        flat = int(np.prod(sched.padded_shape))
        M = sched.M
        shape, taps, rel = (cs // 2 + 1, cs, cs), [], []
        for l in range(1, 5):
            idx, shape = valid_taps(shape, K, l == 1)
            taps.append(idx)
            i, j, k = np.meshgrid(*(np.arange(n) for n in shape), indexing='ij')
            rel.append(((a + b + c) * (l * p - pad) + a * i + b * j + c * k).reshape(-1))
        # layer 3's skip: the layer-1 cell at the same position
        D1, S1 = shape[0] + 3 * p, shape[1] + 6 * p
        i, j, k = np.meshgrid(*(np.arange(n) for n in (p + 1, 2 * p + 1, 2 * p + 1)),
                              indexing='ij')
        skip = (((i + 2 * p) * S1 + j + 2 * p) * S1 + k + 2 * p).reshape(-1)

        def init(sw: ScanWeights, B: int):
            dev = sw.centers.device

            def t(arr):
                return torch.from_numpy(np.asarray(arr, np.int64)).to(dev)

            return {'sw': sw, 'tabs': _sched_tables(sched, str(dev)),
                    'vol': torch.full((B, flat + 1), sw.pad, dtype=torch.float32, device=dev),
                    'taps': [t(x) for x in taps], 'rel': [t(x) for x in rel[:3]],
                    'skip': t(skip)}

        def step_logits(st, t):
            sw, tabs = st['sw'], st['tabs']
            idx = tabs.base_flat[t][:, None] + tabs.ctx_offsets[None, :]
            x = st['vol'][:, idx][..., None]                  # (B, M, patch cells, 1)
            t_pos = tabs.t_lin[t][:, None]
            for l in range(1, 5):
                y = masked_layer(x, l, sw, st['taps'][l - 1])
                if l == 3:
                    y = y + y1[:, :, st['skip']]
                else:
                    y = torch.relu(y)
                if l < 4:     # cells with t' < 0 see only padding
                    y = torch.where((t_pos + st['rel'][l - 1] < 0)[None, ..., None],
                                    sw.k[l - 1], y)
                if l == 1:
                    y1 = y
                x = y
            return x[:, :, 0]

        def write(st, t, sym):
            tabs = st['tabs']
            idx = torch.where(tabs.active[t], tabs.scatter_flat[t], flat)
            st['vol'][:, idx] = st['sw'].centers[sym]

        return ScanRun(sched, init, step_logits, write)


# ---------------------------------------------------------------------------
# The id-7 coder
# ---------------------------------------------------------------------------

SCAN_IMPLS = ('direct', 'cached', 'ring')


def scan_builder(impl: str, pc_config):
    if impl == 'direct':
        return DirectScanBuilder(pc_config)
    if pc_config.kernel_size != 3:
        raise ValueError(f'impl {impl!r} is specialized to kernel_size 3')
    if impl == 'cached':
        from .cached import CachedScanBuilder
        return CachedScanBuilder(pc_config)
    if impl == 'ring':
        from .ring import RingScanBuilder
        return RingScanBuilder(pc_config)
    raise ValueError(f'unknown scan impl {impl!r}; expected one of {SCAN_IMPLS}')


class ScanCoder:
    """Entropy codec for one context model through a scan schedule
    (``impl`` direct / cached / ring), container impl id 7, on ``device``.
    Same submit / finish contract as cuda_codec.CudaCoder."""

    def __init__(self, pc: pc_lib.ProbClassifier, pc_config, device='cuda',
                 impl: str = 'direct'):
        self.device = resolve_device(device)
        self.pc = pc
        self.impl = impl
        self.L = pc.num_centers
        self._builder = scan_builder(impl, pc_config)
        self._folds = cuda_codec.FoldCache(fold_scan_weights)
        self._cols = {}

    @functools.lru_cache(maxsize=8)
    def make_run(self, latent_shape: Tuple[int, int, int]) -> ScanRun:
        return self._builder.make_run(tuple(int(v) for v in latent_shape))

    def lane_totals(self, latent_shape) -> np.ndarray:
        """(r,) active symbols per rANS lane: the base of thresh = total - k."""
        sched = self.make_run(tuple(latent_shape)).sched
        r = rans.lanes(sched.M)
        return sched.active.reshape(sched.T, sched.M // r, r).sum((0, 1)).astype(np.int32)

    def weights(self, centers) -> ScanWeights:
        return self._folds.get(self.pc, centers, self.device)

    def encode_tables(self, symbols, centers):
        """(B, C, H, W) symbols -> (freq_sel, start_sel) (B, T, M) of the
        teacher-forced scan, and the schedule."""
        syms, _, _ = cuda_codec.device_symbols(symbols, self.L, self.device)
        run = self.make_run(tuple(syms.shape[1:]))
        _, fsel, ssel = run_scan(run, self.weights(centers), MODE_ENCODE, syms.shape[0],
                                 true_syms=syms.reshape(syms.shape[0], -1))
        return fsel, ssel, run.sched

    def encode_batch_submit(self, symbols, centers) -> cuda_codec.EncodeHandle:
        syms, host_syms, bad = cuda_codec.device_symbols(symbols, self.L, self.device)
        b = syms.shape[0]
        latent_shape = tuple(int(v) for v in syms.shape[1:])
        run = self.make_run(latent_shape)
        syms_flat = syms.reshape(b, -1)
        _, fsel, ssel = run_scan(run, self.weights(centers), MODE_ENCODE, b,
                                 true_syms=syms_flat)
        active = _sched_tables(run.sched, str(self.device)).active
        tail = int(self.lane_totals(latent_shape).max()) >= codec_lib.TAIL_MIN_LANE_SYMBOLS

        def reverse(x0):
            words, n_words, states, kwarm = rans.encode_reverse_scan_interleaved(
                fsel, ssel, active, x0)
            return ck.to_int32_bits(words), n_words, ck.to_int32_bits(states), kwarm

        return cuda_codec.submit_encode(
            latent_shape, codec_lib.IMPL_WAVEFRONT, self.L, reverse, tail,
            cuda_codec.theoretical_bits(fsel, active), cuda_codec.checksums(syms_flat),
            bad, host_syms, self._cols.get(latent_shape))

    def encode_batch_finish(self, handle) -> Tuple[codec_lib.EncodeResult, ...]:
        return cuda_codec.finish_encode(handle, self._cols)

    def encode_batch(self, symbols, centers) -> Tuple[codec_lib.EncodeResult, ...]:
        return self.encode_batch_finish(self.encode_batch_submit(symbols, centers))

    def decode_batch_submit(self, bitstreams: Sequence[bytes], centers):
        def cap(shape):
            sched = self.make_run(shape).sched
            return sched.T * sched.M

        pb = cuda_codec.parse_batch(bitstreams, cap, self.lane_totals)
        run = self.make_run(pb.latent_shape)
        streams, states, thresh = cuda_codec.upload_parsed(pb, cap(pb.latent_shape),
                                                           self.device)
        b = len(pb.crcs)
        syms, _, _ = run_scan(run, self.weights(centers), MODE_DECODE, b,
                              streams=streams.long(), init_states=states.long(),
                              thresh=thresh.long())
        n = int(np.prod(pb.latent_shape))
        tabs = _sched_tables(run.sched, str(self.device))
        flat = torch.zeros(b, n + 1, dtype=torch.int32, device=self.device)
        idx = torch.where(tabs.active, tabs.sym_flat, n).reshape(-1)
        flat[:, idx] = syms.reshape(b, -1).int()
        return cuda_codec.submit_checks(flat[:, :n].reshape((b,) + tuple(pb.latent_shape)),
                                        pb.crcs)

    def decode_batch_finish(self, handle, verify: bool = True, device_out: bool = True):
        return cuda_codec.finish_decode(handle, verify, device_out)

    def decode_batch(self, bitstreams, centers, verify: bool = True, device_out: bool = True):
        return self.decode_batch_finish(self.decode_batch_submit(bitstreams, centers),
                                        verify, device_out)
