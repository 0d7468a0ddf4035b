"""Driver of the K=3 wavefront codec on the card (counterpart of
imgcomp_cvpr_tpu/coding/pallas_codec.py::PallasCoder, bsub=1, f32).

encode: kernel 2's layer-parallel teacher-forced entry -> per-symbol (freq,
start) -> kernel 3 reverse rANS (x0 = 1 tail packing; a lane whose warmup
exceeds K_CAP sends the batch back through kernel 3 with x0 = RANS_L) ->
container v11. decode: parse -> kernel 2's scan (one image over a
thread-block cluster) with per-lane thresh = lane_totals - k -> CRC checked
on the device. The symbol checksum and the theoretical bits are
computed on the device; only the stream words, states and a few scalars
per image cross to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import probclass as pc_lib
from . import codec as codec_lib
from . import cuda_kernel as ck
from . import rans

_NO_THRESH = np.iinfo(np.int32).max // 2   # the pull guard never binds


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
    ws = [_taps(c.weight.detach().float(), first=(i == 0)).contiguous()
          for i, c in enumerate(convs)]
    bs = [c.bias.detach().float().contiguous() for c in convs]
    pad = float(pc_lib.auto_pad_value(pc.config, centers, pc))
    k1, k2, k3 = pad_constants(pc, pad)
    return ck.FoldedWeights(
        ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3],
        k1.float().to(dev), k2.float().to(dev), k3.float().to(dev),
        torch.full((1,), pad, dtype=torch.float32, device=dev),
        centers.detach().float().contiguous())


def theoretical_bits(fsel: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(B,) float64 sum of -log2(freq / SCALE) over the active entries of
    (B, rows, CQ) tables; active (rows, CQ) bool on the same device."""
    bits = -torch.log2(torch.clamp(fsel.double(), min=1.0) / rans.SCALE)
    return torch.where(active, bits, 0.0).sum((1, 2))


def checksums(syms_flat: torch.Tensor) -> torch.Tensor:
    """(B,) int64 container checksums of (B, n) symbols, on their device."""
    w = torch.from_numpy(codec_lib.crc_weights(syms_flat.shape[1]).astype(np.int64))
    return codec_lib.symbol_crc_device(syms_flat, w.to(syms_flat.device))


def serialize_batch(latent_shape, words, n_words, states, kwarm, theo, crcs,
                    tail: bool, impl_id: int, host_syms=None):
    """Device outputs of a reverse encode -> one EncodeResult per image
    (container v11, precision 0)."""
    theo = theo.cpu().numpy()
    crcs = crcs.cpu().numpy()
    n_words = n_words.cpu().numpy()
    wmax = max(1, int(n_words.max()))
    host_words = words[:, :wmax].cpu().numpy()
    states = states.cpu().numpy().view(np.uint32)
    kwarm = kwarm.cpu().numpy()
    results = []
    for i in range(len(n_words)):
        stream = host_words[i, :n_words[i]][::-1].astype(np.uint32)
        bitstream = codec_lib.serialize_stream(
            latent_shape, stream, states[i], int(crcs[i]), impl_id=impl_id,
            prec=0, k=kwarm[i] if tail else None)
        results.append(codec_lib.EncodeResult(
            bitstream=bitstream, num_bits=len(bitstream) * 8,
            theoretical_bits=float(theo[i]),
            symbols=None if host_syms is None else host_syms[i]))
    return tuple(results)


class ParsedBatch(NamedTuple):
    latent_shape: Tuple[int, int, int]
    words: np.ndarray     # (B, cap) int32 stream words in decode order
    states: np.ndarray    # (B, R) int32 holding the uint32 entry states
    thresh: np.ndarray    # (B, R) int32 pull thresholds (huge if not tail-packed)
    crcs: Tuple[int, ...]


def parse_batch(bitstreams: Sequence[bytes], cap_of, totals_of) -> ParsedBatch:
    """Parse container v11 streams of one latent shape: cap_of(shape) is the
    word capacity, totals_of(shape) the (R,) active symbols per lane, so
    a tail-packed lane has thresh = total - k (no pull in its last k)."""
    parsed = [codec_lib.deserialize_stream(bs) for bs in bitstreams]
    if {codec_lib.stream_prec(bs) for bs in bitstreams} != {0}:
        raise ValueError('only container precision 0 (f32) is ported')
    latent_shape = parsed[0][0]
    if any(p[0] != latent_shape for p in parsed):
        raise ValueError('mixed latent shapes in one decode batch')
    b, cap, totals = len(parsed), cap_of(latent_shape), totals_of(latent_shape)
    packed = np.zeros((b, cap), np.int32)
    states = np.zeros((b, ck.R), np.uint32)
    thresh = np.full((b, ck.R), _NO_THRESH, np.int32)
    for i, (_, words, st, _crc, k) in enumerate(parsed):
        if len(st) != ck.R:
            raise ValueError(f'stream has {len(st)} lanes, expected {ck.R}')
        if len(words) > cap:
            raise ValueError(f'stream length {len(words)} exceeds the word cap {cap}')
        packed[i, :len(words)] = words
        states[i] = st
        if k is not None:
            thresh[i] = totals - k.astype(np.int32)
    return ParsedBatch(latent_shape, packed, states.view(np.int32), thresh,
                       tuple(p[3] for p in parsed))


def verify_crcs(syms_flat: torch.Tensor, expected: Sequence[int]) -> None:
    """Raise unless every image's device-computed checksum matches its
    container's."""
    crcs = checksums(syms_flat).cpu().numpy()
    for i, want in enumerate(expected):
        if int(crcs[i]) != want:
            raise ValueError(
                f'decode CRC mismatch for image {i}: corrupt stream, or '
                'decoded by a different implementation than encoded it')


class CudaCoder:
    """Entropy codec for one context model, wavefront scan on the card
    (kernels 2 and 3); on the CPU the kernels' plain versions run."""

    def __init__(self, pc: pc_lib.ProbClassifier, pc_config, device='cuda'):
        if pc_config.kernel_size != 3:
            raise ValueError('the wavefront codec requires kernel_size 3')
        self.device = resolve_device(device)
        self.pc = pc
        self.L = pc.num_centers

    def _prepare(self, latent_shape, centers):
        centers = torch.as_tensor(centers, dtype=torch.float32).to(self.device)
        sched = ck.build_schedule(latent_shape)
        return sched, fold_weights(self.pc, centers)

    # -- encode ---------------------------------------------------------------

    def encode_batch(self, symbols, centers) -> Tuple[codec_lib.EncodeResult, ...]:
        """symbols: (B, C, H, W) int, a tensor (any device) or numpy."""
        syms = torch.as_tensor(symbols).to(self.device)
        latent_shape = tuple(int(v) for v in syms.shape[1:])
        b = syms.shape[0]
        sched, weights = self._prepare(latent_shape, centers)
        syms_flat = syms.reshape(b, -1).int().contiguous()
        if int(syms_flat.min()) < 0 or int(syms_flat.max()) >= self.L:
            raise ValueError(f'symbols must lie in [0, {self.L})')
        fsel, ssel = ck.wavefront_forward(ck.MODE_ENCODE, weights, latent_shape,
                                          true_syms=syms_flat)
        tail = int(ck.lane_totals(sched).max()) >= codec_lib.TAIL_MIN_LANE_SYMBOLS
        x0 = 1 if tail else rans.RANS_L
        words, n_words, states, kwarm = ck.rans_reverse(fsel, ssel, latent_shape, x0)
        if tail and int(kwarm.max()) > codec_lib.K_CAP:
            # Pathological: a lane needs > K_CAP warmup symbols to reach
            # RANS_L. Re-encode the batch with the classic seed.
            tail = False
            words, n_words, states, kwarm = ck.rans_reverse(
                fsel, ssel, latent_shape, rans.RANS_L)
        tabs = ck.device_tables(latent_shape, str(self.device))
        active = tabs.idx_cm < int(np.prod(latent_shape))
        return serialize_batch(
            latent_shape, words, n_words, states, kwarm,
            theoretical_bits(fsel, active), checksums(syms_flat), tail,
            codec_lib.IMPL_CUDA,
            syms.cpu().numpy() if isinstance(symbols, np.ndarray) else None)

    # -- decode ---------------------------------------------------------------

    def decode_batch(self, bitstreams: Sequence[bytes], centers,
                     verify: bool = True) -> torch.Tensor:
        """-> (B, C, H, W) int32 symbols on the coder's device. With verify,
        raises unless every image's device-computed checksum matches its
        container's."""
        pb = parse_batch(bitstreams, lambda s: ck.build_schedule(s).stream_cap,
                         lambda s: ck.lane_totals(ck.build_schedule(s)))
        sched, weights = self._prepare(pb.latent_shape, centers)
        dev = self.device
        syms = ck.wavefront_forward(
            ck.MODE_DECODE, weights, pb.latent_shape,
            streams=torch.from_numpy(pb.words).to(dev),
            init_states=torch.from_numpy(pb.states).to(dev),
            thresh=torch.from_numpy(pb.thresh).to(dev))
        if verify:
            verify_crcs(syms, pb.crcs)
        return syms.reshape((len(pb.crcs),) + tuple(pb.latent_shape))
