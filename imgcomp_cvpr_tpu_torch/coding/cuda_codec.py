"""Driver of the K=3 wavefront codec on the card (counterpart of
imgcomp_cvpr_tpu/coding/pallas_codec.py::PallasCoder at bsub=1, at each of
its ring precisions f32, bf16 and f8: the container's prec byte 0, 1, 2).

encode: kernel 2's layer-parallel teacher-forced entry -> per-symbol (freq,
start) -> kernel 3 reverse rANS (x0 = 1 tail packing; a lane whose warmup
exceeds K_CAP sends the batch back through kernel 3 with x0 = RANS_L) ->
container v11. decode: parse -> kernel 2's scan (one image over a
thread-block cluster) at the streams' own precision, with per-lane thresh =
lane_totals - k -> CRC checked on the device. The symbol checksum and the
theoretical bits are computed on the device; only the stream words, states
and a few scalars per image cross to the host.

Each direction is split as in the reference (pallas_codec.py:421-625): a
submit enqueues the device work on the current stream, starts non-blocking
copies between pinned host buffers and the card, records an event and
returns; a finish waits for that event only, then serializes or checks.
So the host's serialize and parse of one batch overlap the card's work on
the next (bench_torch.py's depth-2 pipeline). While a profiler records,
the finish calls' waits, serialize and parse (with the upload) are the
spans ``codec.wait``, ``codec.serialize`` and ``codec.parse``
(utils/spans.py), shared by every coder that uses these functions.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import probclass as pc_lib
from ..utils.spans import span
from . import codec as codec_lib
from . import cuda_kernel as ck
from . import rans

_NO_THRESH = np.iinfo(np.int32).max // 2   # the pull guard never binds
# The variable that names the encode precision (f32, bf16 or f8) of a coder
# given none, read as the JAX package's PallasCoder reads it
# (pallas_codec.py:174-196).
PREC_ENV = 'IMGCOMP_PALLAS_PREC'


def encode_prec(prec=None) -> int:
    """The prec byte an encode writes: ``prec`` ('f32' / 'bf16' / 'f8' or
    0 / 1 / 2) when given, else $IMGCOMP_PALLAS_PREC, else 0. The JAX
    package picks bf16 for even batches, to fit its rings into the TPU's
    VMEM; the card holds no such ring, and f32 keeps the streams that the
    port has always written. Raises on an unknown value."""
    if prec is None:
        forced = os.environ.get(PREC_ENV)
        if not forced:
            return 0
        if forced not in ck.PRECS:
            raise ValueError(f'{PREC_ENV}={forced!r}: expected one of {ck.PRECS}')
        prec = forced
    return ck.prec_id(prec)


def _taps(weight: torch.Tensor, first: bool) -> torch.Tensor:
    """(cout, cin, 2, 3, 3) masked-conv weight -> (ntaps, cin, cout) over
    the unmasked taps in window order."""
    cols = []
    for o in ck._unmasked_taps(first):
        dz, dy, dx = ck._WINDOW[o]
        cols.append(weight[:, :, dz, dy, dx].t())
    return torch.stack(cols)


def pad_constants(pc: pc_lib.ProbClassifier, pad: float):
    """(k1, k2, k3) float64 (kf,) on the host: the activation of layers 1-3
    over an all-pad volume (ring.py:_pad_constants). A VALID conv of a
    constant volume is constant, so each constant is one channel vector: the
    sum of the layer's masked taps (window order) applied to the constant
    below. Computed in float64 and rounded once by the caller, so encoder
    and decoder always agree on them. Any kernel_size."""
    net = pc.net
    K = net.kernel_size
    kd = pc_lib.filter_depth(K)
    w64, b64 = [], []
    for i, conv in enumerate((net.conv0, net.res1.conv1, net.res1.conv2)):
        m = pc_lib.spatial_mask(K, first=(i == 0))
        w = conv.weight.detach().float()
        cols = [w[:, :, dz, dy, dx].t() for dz in range(kd) for dy in range(K)
                for dx in range(K) if dz < kd - 1 or m[dy, dx] > 0]
        w64.append(torch.stack(cols).double().cpu().sum(0))
        b64.append(conv.bias.detach().double().cpu())
    k1 = torch.relu(torch.full((1,), pad, dtype=torch.float64) @ w64[0] + b64[0])
    k2 = torch.relu(k1 @ w64[1] + b64[1])
    k3 = k2 @ w64[2] + b64[2] + k1
    return k1, k2, k3


def fold_weights(pc: pc_lib.ProbClassifier, centers: torch.Tensor
                 ) -> ck.FoldedWeights:
    """Masked-tap weight folding (cached.py:_layer_weights) plus the all-pad
    activation constants of each layer (pad_constants)."""
    net = pc.net
    dev = centers.device
    convs = (net.conv0, net.res1.conv1, net.res1.conv2, net.conv_out)
    ws = [_taps(c.weight.detach().float(), first=(i == 0)).to(dev).contiguous()
          for i, c in enumerate(convs)]
    bs = [c.bias.detach().float().to(dev).contiguous() for c in convs]
    pad = float(pc_lib.auto_pad_value(pc.config, centers, pc))
    k1, k2, k3 = pad_constants(pc, pad)
    return ck.FoldedWeights(
        ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
        k1.float().to(dev), k2.float().to(dev), k3.float().to(dev),
        torch.full((1,), pad, dtype=torch.float32, device=dev),
        centers.detach().float().contiguous())




class FoldCache:
    """The folded weights of the last (context model, centers) pair a coder
    was given, folded again when either changes, and their operands at each
    precision asked for. Folding reads weights on the host (pad_constants,
    the pad value): a wait for the card that a submit must not pay every
    batch. The key is the centers' values, read on the host (centers given
    as a CUDA tensor cost one read of their L floats), each parameter's
    storage and version counter, which every in-place update (an optimizer
    step, load_state_dict) moves, and the precision: ``derive(fold, prec)``
    makes the operands of a nonzero precision from the float32 fold."""

    def __init__(self, fold_fn, derive=None):
        self._fold_fn, self._derive = fold_fn, derive
        self._key, self._folds = None, {}

    def get(self, pc: pc_lib.ProbClassifier, centers, device: torch.device, prec: int = 0):
        if isinstance(centers, torch.Tensor):
            host = centers.detach().to('cpu', torch.float32)
        else:
            host = torch.from_numpy(np.asarray(centers, np.float32))
        key = (host.numpy().tobytes(),
               tuple((p.data_ptr(), p._version) for p in pc.parameters()))
        if key != self._key:
            self._folds = {0: self._fold_fn(pc, host.to(device, copy=True))}
            self._key = key
        if prec not in self._folds:
            if self._derive is None:
                raise ValueError(f'precision {prec} has no operands for this coder')
            self._folds[prec] = self._derive(self._folds[0], prec)
        return self._folds[prec]


def theoretical_bits(fsel: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(B,) float64 sum of -log2(freq / SCALE) over the active entries of
    (B, rows, CQ) tables; active (rows, CQ) bool on the same device."""
    bits = -torch.log2(torch.clamp(fsel.double(), min=1.0) / rans.SCALE)
    return torch.where(active, bits, 0.0).sum((1, 2))


@functools.lru_cache(maxsize=8)
def _crc_weights(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(codec_lib.crc_weights(n).astype(np.int64)).to(device)


def checksums(syms_flat: torch.Tensor) -> torch.Tensor:
    """(B,) int64 container checksums of (B, n) symbols, on their device
    (the weights are uploaded once a length and device)."""
    return codec_lib.symbol_crc_device(syms_flat, _crc_weights(syms_flat.shape[1],
                                                               syms_flat.device))


# ---------------------------------------------------------------------------
# Host <-> card without waiting: pinned buffers, non-blocking copies, events
# ---------------------------------------------------------------------------

def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``. To a card the bytes go through a
    pinned buffer with a non-blocking copy on the current stream: the host
    does not wait, and PyTorch's pinned-memory cache hands that buffer out
    again only after the copy has completed."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start copying ``t`` into a new pinned host buffer on the current
    stream and return the buffer, still being filled: read it only after an
    event recorded after the copy has completed. A CPU tensor is its own."""
    if t.device.type != 'cuda':
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


def record_event(device: torch.device) -> Optional[torch.cuda.Event]:
    if device.type != 'cuda':
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def device_symbols(symbols, L: int, device: torch.device):
    """(B, C, H, W) int symbols -> (int32 contiguous tensor on ``device``,
    the host array when numpy was given, a 0-d range flag or None).

    A tensor already on the coder's kind of device is checked there: one
    reduction into a flag that finish reads, and a clamp into [0, L) so that
    no kernel indexes outside its tables (a valid symbol is left as it is).
    Anything else is checked on the host, then uploaded."""
    if isinstance(symbols, torch.Tensor) and symbols.device.type == device.type:
        syms = symbols.to(device).int().contiguous()
        return syms.clamp(0, L - 1), None, ((syms < 0) | (syms >= L)).any()
    host = (symbols.cpu().numpy() if isinstance(symbols, torch.Tensor)
            else np.asarray(symbols))
    if host.size and (int(host.min()) < 0 or int(host.max()) >= L):
        raise ValueError(f'symbols must lie in [0, {L})')
    return (upload(host.astype(np.int32), device),
            host if isinstance(symbols, np.ndarray) else None, None)


# ---------------------------------------------------------------------------
# Encode: submit / finish (shared by the wavefront and the planar coder)
# ---------------------------------------------------------------------------

class EncodeHandle(NamedTuple):
    """A submitted encode. ``host`` holds pinned buffers that are being
    filled until ``event`` (None on the CPU) has completed: the first
    ``cols`` stream words of each image, n_words, states, warmup counts,
    theoretical bits and checksums."""
    latent_shape: Tuple[int, int, int]
    impl_id: int
    prec: int                           # the container's prec byte
    L: int
    tail: bool
    words: torch.Tensor                 # (B, cap) int32 stream words on the device
    host: Tuple[torch.Tensor, ...]
    bad: Optional[torch.Tensor]         # host copy of the device symbol-range flag
    reverse: Optional[Callable]         # x0 -> reverse encode, for the K_CAP case
    host_syms: Optional[np.ndarray]
    event: Optional[torch.cuda.Event]


def submit_encode(latent_shape, impl_id: int, L: int, reverse: Callable, tail: bool,
                  theo: torch.Tensor, crcs: torch.Tensor, bad, host_syms,
                  cols: Optional[int], prec: int = 0) -> EncodeHandle:
    """Enqueue the reverse encoder (x0 = 1 with tail packing, else RANS_L)
    and the copies of what serialize needs, and return at once. ``cols`` is
    how many stream words of each image to copy, predicted from the last
    batch of this shape (None: the whole buffer); finish copies the rest
    when an image's stream is longer. ``reverse`` (which holds the tables)
    is kept only with tail packing, where finish may need it again."""
    words, n_words, states, kwarm = reverse(1 if tail else rans.RANS_L)
    cols = words.shape[1] if cols is None else min(cols, words.shape[1])
    host = tuple(to_host(t) for t in (words[:, :cols], n_words, states, kwarm, theo, crcs))
    return EncodeHandle(tuple(latent_shape), impl_id, prec, L, tail, words, host,
                        None if bad is None else to_host(bad),
                        reverse if tail else None, host_syms, record_event(words.device))


def _words_after(h: EncodeHandle, cols: int) -> np.ndarray:
    """h.words[:, :cols] on the host, copied on a side stream that waits for
    h's event only, not for what the caller queued since."""
    if h.event is None:
        return h.words[:, :cols].numpy()
    side = torch.cuda.Stream(h.words.device)
    side.wait_event(h.event)
    with span('codec.wait'), torch.cuda.stream(side):
        return h.words[:, :cols].cpu().numpy()


def finish_encode(h: EncodeHandle, cols_pred: dict) -> Tuple[codec_lib.EncodeResult, ...]:
    """Wait for h's event (never for the whole card), raise for a symbol
    out of range, re-encode with x0 = RANS_L when a lane's warmup passed
    K_CAP, and serialize. Records in ``cols_pred`` the stream words to copy
    for the next batch of this shape: this batch's longest stream + 1/8."""
    with span('codec.wait'):
        if h.event is not None:
            h.event.synchronize()
    if h.bad is not None and bool(h.bad):
        raise ValueError(f'symbols must lie in [0, {h.L})')
    words, n_words, states, kwarm, theo, crcs = (t.numpy() for t in h.host)
    tail = h.tail
    if tail and int(kwarm.max()) > codec_lib.K_CAP:
        # Pathological: a lane needs > K_CAP warmup symbols to reach
        # RANS_L. Re-encode the batch with the classic seed.
        tail = False
        words, n_words, states, kwarm = (t.cpu().numpy() for t in h.reverse(rans.RANS_L))
    else:
        wmax = max(1, int(n_words.max()))
        if wmax > words.shape[1]:
            words = _words_after(h, wmax)
        cols_pred[h.latent_shape] = ck._round_up(wmax + wmax // 8, 128)
    return serialize_batch(h.latent_shape, words, n_words, states.view(np.uint32), kwarm,
                           theo, crcs, tail, h.impl_id, h.host_syms, h.prec)


def serialize_batch(latent_shape, words, n_words, states, kwarm, theo, crcs,
                    tail: bool, impl_id: int, host_syms=None, prec: int = 0):
    """Host arrays of a reverse encode -> one EncodeResult per image
    (container v11 with prec byte ``prec``); words (B, >= max n_words) in
    emission order."""
    results = []
    with span('codec.serialize'):
        for i in range(len(n_words)):
            stream = words[i, :n_words[i]][::-1].astype(np.uint32)
            bitstream = codec_lib.serialize_stream(
                latent_shape, stream, states[i], int(crcs[i]), impl_id=impl_id,
                prec=prec, k=kwarm[i] if tail else None)
            results.append(codec_lib.EncodeResult(
                bitstream=bitstream, num_bits=len(bitstream) * 8,
                theoretical_bits=float(theo[i]),
                symbols=None if host_syms is None else host_syms[i]))
    return tuple(results)


# ---------------------------------------------------------------------------
# Decode: parse, upload, submit / finish
# ---------------------------------------------------------------------------

class ParsedBatch(NamedTuple):
    latent_shape: Tuple[int, int, int]
    words: np.ndarray     # (B, W) int32 stream words in decode order, W the longest stream
    states: np.ndarray    # (B, R) int32 holding the uint32 entry states
    thresh: np.ndarray    # (B, R) int32 pull thresholds (huge if not tail-packed)
    crcs: Tuple[int, ...]
    prec: int             # the streams' prec byte


def parse_batch(bitstreams: Sequence[bytes], cap_of, totals_of,
                precs: Tuple[int, ...] = (0,)) -> ParsedBatch:
    """Parse container v11 streams of one latent shape and one precision
    (a prec byte in ``precs``: the K=3 wavefront codec decodes 0, 1 and 2,
    the planar codec writes and decodes 0 only): cap_of(shape) is
    the word capacity, totals_of(shape) the (r,) active symbols per lane, so
    a tail-packed lane has thresh = total - k (no pull in its last k)."""
    with span('codec.parse'):
        parsed = [codec_lib.deserialize_stream(bs) for bs in bitstreams]
        found = {codec_lib.stream_prec(bs) for bs in bitstreams}
        if len(found) != 1:
            raise ValueError(f'mixed stream precisions {sorted(found)} in one decode batch')
        prec = found.pop()
        if prec not in precs:
            name = ck.PRECS[prec] if prec < len(ck.PRECS) else 'unknown'
            why = (' (precisions 1 and 2 are the K=3 wavefront codec\'s, impl id 5)'
                   if prec < len(ck.PRECS) else '')
            raise ValueError(
                f'container precision {prec} ({name}) is not decodable here: this codec '
                f'writes and decodes precision {", ".join(map(str, precs))} only' + why)
        latent_shape = parsed[0][0]
        if any(p[0] != latent_shape for p in parsed):
            raise ValueError('mixed latent shapes in one decode batch')
        b, cap, totals = len(parsed), cap_of(latent_shape), totals_of(latent_shape)
        r = len(totals)
        packed = np.zeros((b, max([1] + [len(p[1]) for p in parsed])), np.int32)
        states = np.zeros((b, r), np.uint32)
        thresh = np.full((b, r), _NO_THRESH, np.int32)
        for i, (_, words, st, _crc, k) in enumerate(parsed):
            if len(st) != r:
                raise ValueError(f'stream has {len(st)} lanes, expected {r}')
            if len(words) > cap:
                raise ValueError(f'stream length {len(words)} exceeds the word cap {cap}')
            packed[i, :len(words)] = words
            states[i] = st
            if k is not None:
                thresh[i] = totals - k.astype(np.int32)
        return ParsedBatch(latent_shape, packed, states.view(np.int32), thresh,
                           tuple(p[3] for p in parsed), prec)


def upload_parsed(pb: ParsedBatch, cap: int, device: torch.device):
    """(streams (B, cap), states (B, R), thresh (B, R)) int32 on ``device``,
    uploaded without waiting; the words go up (B, W) and are padded with
    zeros to the kernels' capacity on the device."""
    with span('codec.parse'):
        streams = torch.zeros(len(pb.crcs), cap, dtype=torch.int32, device=device)
        streams[:, :pb.words.shape[1]] = upload(pb.words, device)
        return streams, upload(pb.states, device), upload(pb.thresh, device)


class DecodeHandle(NamedTuple):
    """A submitted decode: the symbols on the device, the containers'
    checksums and the device-computed ones, copying to a pinned buffer until
    ``event`` (None on the CPU) has completed."""
    syms: torch.Tensor           # (B, C, H, W) int32 on the coder's device
    crcs: Tuple[int, ...]
    host_crcs: torch.Tensor
    event: Optional[torch.cuda.Event]


def submit_checks(syms: torch.Tensor, crcs: Sequence[int]) -> DecodeHandle:
    """Enqueue the decoded symbols' checksums and their copy to the host."""
    host = to_host(checksums(syms.reshape(syms.shape[0], -1)))
    return DecodeHandle(syms, tuple(crcs), host, record_event(syms.device))


def finish_decode(h: DecodeHandle, verify: bool = True, device_out: bool = True):
    """-> the (B, C, H, W) int32 symbols: the device tensor with
    ``device_out`` (the port's default), else a host np.int32 array, as the
    reference returns. With ``verify``, waits for h's event and raises
    unless every image's device-computed checksum matches its container's."""
    if verify:
        with span('codec.wait'):
            if h.event is not None:
                h.event.synchronize()
        got = h.host_crcs.numpy()
        for i, want in enumerate(h.crcs):
            if int(got[i]) != want:
                raise ValueError(
                    f'decode CRC mismatch for image {i}: corrupt stream, or '
                    'decoded by a different implementation than encoded it')
    return h.syms if device_out else h.syms.cpu().numpy()


class CudaCoder:
    """Entropy codec for one context model, wavefront scan on the card
    (kernels 2 and 3); on the CPU the kernels' plain versions run. The
    submit calls enqueue on the current stream and do not wait for the card;
    the finish calls wait for their own batch's event only.

    ``prec`` ('f32' / 'bf16' / 'f8', or the prec byte) is the operand
    precision of kernel 2 that encode writes; None reads $IMGCOMP_PALLAS_PREC
    at each encode (encode_prec), f32 when it is unset. Decode runs each
    batch at its streams' own precision, whatever ``prec`` is."""

    def __init__(self, pc: pc_lib.ProbClassifier, pc_config, device='cuda', prec=None):
        if pc_config.kernel_size != 3:
            raise ValueError('the wavefront codec requires kernel_size 3')
        self.device = resolve_device(device)
        self.pc = pc
        self.L = pc.num_centers
        self.prec = None if prec is None else ck.prec_id(prec)
        self._folds = FoldCache(fold_weights, ck.operand_weights)
        self._cols = {}        # latent shape -> stream words to copy at submit

    def _prepare(self, latent_shape, centers, prec: int = 0):
        return (ck.build_schedule(tuple(latent_shape)),
                self._folds.get(self.pc, centers, self.device, prec))

    # -- encode ---------------------------------------------------------------

    def encode_batch_submit(self, symbols, centers) -> EncodeHandle:
        """Enqueue an encode: kernel 2's layer-parallel encode, kernel 3, the
        checksums, the theoretical bits and the copies to pinned buffers.
        symbols: (B, C, H, W) int, a tensor (any device) or numpy; centers:
        (L,) numpy or tensor (see FoldCache)."""
        prec = encode_prec(self.prec)
        syms, host_syms, bad = device_symbols(symbols, self.L, self.device)
        b = syms.shape[0]
        latent_shape = tuple(int(v) for v in syms.shape[1:])
        sched, weights = self._prepare(latent_shape, centers, prec)
        syms_flat = syms.reshape(b, -1)
        fsel, ssel = ck.wavefront_forward(ck.MODE_ENCODE, weights, latent_shape,
                                          true_syms=syms_flat, prec=prec)
        tail = int(ck.lane_totals(sched).max()) >= codec_lib.TAIL_MIN_LANE_SYMBOLS
        tabs = ck.device_tables(latent_shape, str(self.device))
        active = tabs.idx_cm < int(np.prod(latent_shape))
        return submit_encode(
            latent_shape, codec_lib.IMPL_CUDA, self.L,
            lambda x0: ck.rans_reverse(fsel, ssel, latent_shape, x0), tail,
            theoretical_bits(fsel, active), checksums(syms_flat), bad, host_syms,
            self._cols.get(latent_shape), prec)

    def encode_batch_finish(self, handle: EncodeHandle) -> Tuple[codec_lib.EncodeResult, ...]:
        return finish_encode(handle, self._cols)

    def encode_batch(self, symbols, centers) -> Tuple[codec_lib.EncodeResult, ...]:
        return self.encode_batch_finish(self.encode_batch_submit(symbols, centers))

    # -- decode ---------------------------------------------------------------

    def decode_batch_submit(self, bitstreams: Sequence[bytes], centers) -> DecodeHandle:
        """Parse on the host, upload without waiting, enqueue kernel 2's scan
        (at the streams' precision) and the checksums."""
        pb = parse_batch(bitstreams, lambda s: ck.build_schedule(s).stream_cap,
                         lambda s: ck.lane_totals(ck.build_schedule(s)),
                         precs=tuple(range(len(ck.PRECS))))
        sched, weights = self._prepare(pb.latent_shape, centers, pb.prec)
        streams, states, thresh = upload_parsed(pb, sched.stream_cap, self.device)
        syms = ck.wavefront_forward(ck.MODE_DECODE, weights, pb.latent_shape,
                                    streams=streams, init_states=states, thresh=thresh,
                                    prec=pb.prec)
        return submit_checks(syms.reshape((len(pb.crcs),) + tuple(pb.latent_shape)), pb.crcs)

    def decode_batch_finish(self, handle: DecodeHandle, verify: bool = True,
                            device_out: bool = True):
        return finish_decode(handle, verify, device_out)

    def decode_batch(self, bitstreams: Sequence[bytes], centers, verify: bool = True,
                     device_out: bool = True):
        """-> (B, C, H, W) int32 symbols (see finish_decode)."""
        return self.decode_batch_finish(self.decode_batch_submit(bitstreams, centers),
                                        verify, device_out)
