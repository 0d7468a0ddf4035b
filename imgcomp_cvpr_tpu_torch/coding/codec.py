"""Container v11, symbol checksum and the LatentCodec facade (port of the
container half of imgcomp_cvpr_tpu/coding/codec.py:41-146,586-1041).

The container bytes are the JAX package's, byte for byte, for the same
inputs and impl id; the port writes its own impl ids, since logits computed
on a GPU are not bitwise those of a TPU and a stream decodes only through
the implementation that encoded it: IMPL_CUDA = 5 (the K=3 wavefront codec)
and IMPL_CUDA_PLANAR = 6 (the planar codec). Id 7 (IMPL_WAVEFRONT) was the
port's scan codecs, since retired: its streams are refused like ids 0-4,
and a codec that takes the id again needs a pinned digest of its own. Only
container v11 is parsed (the frozen v8-v10 branches are not ported).
"""

from __future__ import annotations

import io
from typing import NamedTuple, Tuple

import numpy as np
import torch

MAGIC = b'\xa7'
VERSION = 11

# Ids 0-4 are the JAX package's (named as it names them; the port decodes
# none of them); 5 and 6 are the port's, 7 its retired scan codecs'.
IMPL_DIRECT, IMPL_CACHED, IMPL_RING, IMPL_PALLAS, IMPL_PLANAR = 0, 1, 2, 3, 4
IMPL_CUDA, IMPL_CUDA_PLANAR, IMPL_WAVEFRONT = 5, 6, 7
IMPL_NAMES = {IMPL_DIRECT: 'direct', IMPL_CACHED: 'cached', IMPL_RING: 'ring',
              IMPL_PALLAS: 'pallas', IMPL_PLANAR: 'planar', IMPL_CUDA: 'cuda',
              IMPL_CUDA_PLANAR: 'cuda_planar', IMPL_WAVEFRONT: 'wavefront'}
# The id each of the port's impls writes.
IMPL_IDS = {'cuda': IMPL_CUDA, 'cuda_planar': IMPL_CUDA_PLANAR}
IMPLS = ('auto',) + tuple(IMPL_IDS)

TAIL_MIN_LANE_SYMBOLS = 256   # tail packing only for lanes this long (tiny
                              # latents would pay more for the k-table than
                              # their 1-2-symbol lanes save)
K_CAP = 65535                 # per-lane warmup cap; above it an image is
                              # re-encoded with the classic x0=RANS_L seed

# ---------------------------------------------------------------------------
# Symbol-volume checksum (weighted mod-2^32 sum, computable on the device)
# ---------------------------------------------------------------------------

_CK_MULT = np.uint64(2654435761)
_CK_MASK = np.uint64(0xFFFFFFFF)


def symbol_crc(symbols: np.ndarray) -> int:
    x = np.ascontiguousarray(symbols, np.int8).reshape(-1)
    v = (x.astype(np.uint64) & np.uint64(0xFF)) + np.uint64(1)
    i = np.arange(v.size, dtype=np.uint64)
    w = ((i * _CK_MULT) & _CK_MASK) | np.uint64(1)
    s1 = int(v.sum() & _CK_MASK)
    s2 = int((((v * w) & _CK_MASK).sum()) & _CK_MASK)
    rot = ((s2 << 16) | (s2 >> 16)) & 0xFFFFFFFF
    return (s1 ^ rot) & 0xFFFFFFFF


def crc_weights(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    return (((i * _CK_MULT) & _CK_MASK) | np.uint64(1)).astype(np.uint32)


def symbol_crc_device(symbols_flat: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """torch twin of symbol_crc on a (..., n) int volume, on any device;
    weights = crc_weights(n) as int64. Returns (...,) int64 in [0, 2^32)."""
    mask = 0xFFFFFFFF
    v = (symbols_flat.long() & 0xFF) + 1
    s1 = v.sum(-1) & mask
    s2 = ((v * weights) & mask).sum(-1) & mask
    rot = ((s2 << 16) | (s2 >> 16)) & mask
    return s1 ^ rot


class EncodeResult(NamedTuple):
    bitstream: bytes
    num_bits: int               # len(bitstream) * 8
    theoretical_bits: float     # sum of -log2(freq/SCALE) over all symbols
    symbols: np.ndarray         # what was encoded (C, H, W), or None


# ---------------------------------------------------------------------------
# Bitstream container v11
# ---------------------------------------------------------------------------

def _read_bits(data: bytes, base: int, bitoff: int, n: int) -> int:
    """Read n (<= 16) bits at bit offset bitoff from data[base:]."""
    byte0 = base + bitoff // 8
    chunk = int.from_bytes(data[byte0:byte0 + 4], 'little')
    return (chunk >> (bitoff % 8)) & ((1 << n) - 1)


def _zigzag(res: np.ndarray) -> np.ndarray:
    return np.where(res >= 0, 2 * res, -2 * res - 1).astype(np.int64)


def _best_rice_param(z: np.ndarray) -> Tuple[int, int]:
    best_m, best = 0, None
    for m in range(16):
        c = int(np.sum(z >> m)) + len(z) * (1 + m)
        if best is None or c < best:
            best_m, best = m, c
    return best_m, best


def _rice_pack_bits(k: np.ndarray, acc: int, nb: int):
    """Exact-min flat / Rice-median / Rice-delta code of a small
    non-negative integer array, appended to an LSB-first accumulator (the
    v11 k-table and state-descriptor code)."""
    r = len(k)

    def anchor_bits(a):
        return 5 + max(a.bit_length() - 1, 0)

    kmin = int(k.min())
    kw = max(1, int(k.max() - kmin).bit_length())
    z_med = _zigzag(k - int(np.median(k)))
    med_m, med_payload = _best_rice_param(z_med)
    cands = [
        (anchor_bits(kmin) + 1 + 4 + r * kw, 0, kmin, kw - 1, None),
        (anchor_bits(int(np.median(k))) + 2 + 4 + med_payload,
         1, int(np.median(k)), med_m, z_med),
    ]
    if r > 1:
        z_d = _zigzag(np.diff(k.astype(np.int64)))
        d_m, d_payload = _best_rice_param(z_d)
        cands.append((anchor_bits(int(k[0])) + 2 + 4 + d_payload,
                      2, int(k[0]), d_m, z_d))
    _, scheme, anchor, param, z = min(cands, key=lambda c: c[0])
    ln = anchor.bit_length()
    assert ln <= 16
    acc |= ln << nb
    nb += 5
    if ln:
        acc |= (anchor - (1 << (ln - 1))) << nb
        nb += ln - 1
    if scheme == 0:
        nb += 1                                      # flat: bit 0
        acc |= param << nb
        nb += 4
        for kv in k:
            acc |= (int(kv) - anchor) << nb
            nb += param + 1
    else:
        acc |= 1 << nb                               # Rice
        nb += 1
        acc |= (scheme - 1) << nb                    # 0 median / 1 delta
        nb += 1
        acc |= param << nb
        nb += 4
        for zv in z:
            q = int(zv) >> param
            acc |= ((1 << q) - 1) << nb
            nb += q + 1
            acc |= (int(zv) & ((1 << param) - 1)) << nb
            nb += param
    return acc, nb


def _rice_unpack_bits(r: int, data: bytes, pos: int, bits: int):
    ln = _read_bits(data, pos, bits, 5)
    bits += 5
    if ln > 16:
        raise ValueError('corrupt rice table (anchor length)')
    anchor = 0
    if ln:
        anchor = (1 << (ln - 1)) | _read_bits(data, pos, bits, ln - 1)
        bits += ln - 1
    scheme = _read_bits(data, pos, bits, 1)
    bits += 1
    if scheme:
        scheme += _read_bits(data, pos, bits, 1)
        bits += 1
    param = _read_bits(data, pos, bits, 4)
    bits += 4
    k = np.empty(r, np.int32)
    if scheme == 0:
        kw = param + 1
        for i in range(r):
            k[i] = anchor + _read_bits(data, pos, bits, kw)
            bits += kw
    else:
        qcap = 2 * K_CAP + 2
        if scheme == 2:
            k[0] = anchor
        for i in range(1 if scheme == 2 else 0, r):
            q = 0
            while _read_bits(data, pos, bits, 1):
                q += 1
                bits += 1
                if q > qcap or pos + (bits >> 3) >= len(data):
                    raise ValueError('corrupt rice table (unbounded unary)')
            bits += 1
            z = (q << param) | _read_bits(data, pos, bits, param)
            bits += param
            res = (z >> 1) if (z & 1) == 0 else -((z + 1) >> 1)
            k[i] = (k[i - 1] + res) if scheme == 2 else (anchor + res)
    return k, bits


def _pack_states(final_states: np.ndarray, wide: bool = False) -> bytes:
    """R decoder-entry states: raw lo words, a scheme-selected hi
    bit-length descriptor table (Rice or per-lane 4-bit), hi mantissas."""
    st = np.asarray(final_states, np.uint64)
    lo = (st & np.uint64(0xFFFF)).astype(np.uint16)
    his = [int(v) for v in (st >> np.uint64(16))]
    if wide:
        ln = [h.bit_length() for h in his]
        mw = [max(l - 1, 0) for l in ln]
    else:
        assert min(his) >= 1, 'rANS state below the renormalization interval'
        ln = [h.bit_length() - 1 for h in his]
        mw = ln
    acc1, nb1 = _rice_pack_bits(np.asarray(ln, np.int64), 1, 1)
    acc0, nb0 = 0, 1
    for l in ln:
        if wide and l >= 15:
            acc0 |= (15 | ((l - 15) << 4)) << nb0
            nb0 += 5
        else:
            acc0 |= l << nb0
            nb0 += 4
    acc, nbits = (acc1, nb1) if nb1 < nb0 else (acc0, nb0)
    for h, w in zip(his, mw):
        if w:
            acc |= (h - (1 << w)) << nbits
            nbits += w
    return lo.tobytes() + acc.to_bytes((nbits + 7) // 8, 'little')


def _unpack_states(r: int, data: bytes, pos: int, wide: bool = False):
    if pos + 2 * r > len(data):
        raise ValueError('truncated container (state block)')
    lo = np.frombuffer(data[pos:pos + 2 * r], np.uint16)
    base = pos + 2 * r
    scheme = _read_bits(data, base, 0, 1)
    bits = 1
    lnmax = 16 if wide else 15
    if scheme:
        lns, bits = _rice_unpack_bits(r, data, base, bits)
        if lns.min() < 0 or lns.max() > lnmax:
            raise ValueError('corrupt container (state descriptors)')
        ln = [int(v) for v in lns]
    else:
        ln = []
        for _ in range(r):
            l = _read_bits(data, base, bits, 4)
            bits += 4
            if wide and l == 15:
                l += _read_bits(data, base, bits, 1)
                bits += 1
            ln.append(l)
    hi = np.empty(r, np.uint32)
    for i, l in enumerate(ln):
        if wide and l == 0:
            hi[i] = 0
            continue
        w = l - 1 if wide else l
        hi[i] = (1 << w) | _read_bits(data, base, bits, w)
        bits += w
    consumed = 2 * r + (bits + 7) // 8
    if pos + consumed > len(data):
        raise ValueError('truncated container (state block)')
    return (hi.astype(np.uint32) << np.uint32(16)) | lo.astype(np.uint32), consumed


def serialize_stream(latent_shape, stream_words: np.ndarray,
                     final_states: np.ndarray, sym_crc: int = 0,
                     impl_id: int = IMPL_CUDA, prec: int = 0, k=None) -> bytes:
    """Container v11: bit-packed header magic(8) version(4) impl(3) tail(1)
    prec(2) rawesc(1) shapewide(1) nstates(7) shapenarrow(1) shape(3x8/12/16)
    crc(32); the packed states; the k-table when tail-packed (k != None);
    the 16-bit stream words."""
    r = len(final_states)
    assert r < 128
    packed = _pack_states(final_states, wide=k is not None)
    rawesc = len(packed) > 4 * r
    if rawesc:
        packed = np.asarray(final_states).astype(np.uint32).tobytes()
    shape = tuple(int(v) for v in latent_shape)
    assert len(shape) == 3 and all(0 <= v < (1 << 16) for v in shape), shape
    shapewide = any(v >= (1 << 12) for v in shape)
    shapenarrow = all(v < (1 << 8) for v in shape)
    hdr = int.from_bytes(MAGIC, 'little')
    hdr |= VERSION << 8
    hdr |= (impl_id & 0x7) << 12
    hdr |= (1 if k is not None else 0) << 15
    hdr |= (prec & 0x3) << 16
    hdr |= (1 if rawesc else 0) << 18
    hdr |= (1 if shapewide else 0) << 19
    hdr |= r << 20
    hdr |= (1 if shapenarrow else 0) << 27
    pos = 28
    sw = 16 if shapewide else (8 if shapenarrow else 12)
    for v in shape:
        hdr |= v << pos
        pos += sw
    hdr |= (sym_crc & 0xFFFFFFFF) << pos
    pos += 32
    buf = io.BytesIO()
    buf.write(hdr.to_bytes((pos + 7) // 8, 'little'))
    buf.write(packed)
    if k is not None:
        k = np.asarray(k, np.int64)
        assert len(k) == r and k.min() >= 0 and k.max() <= K_CAP
        acc, nb = _rice_pack_bits(k, 0, 0)
        buf.write(acc.to_bytes((nb + 7) // 8, 'little'))
    buf.write(np.asarray(stream_words).astype(np.uint16).tobytes())
    return buf.getvalue()


def deserialize_stream(data: bytes):
    """-> (latent_shape, stream_words, states, sym_crc, k); k is None for
    x0=RANS_L streams, else the (R,) int32 warmup table."""
    if data[:1] != MAGIC:
        raise ValueError('bad magic')
    version = data[1] & 0xF
    if version != VERSION:
        raise ValueError(f'unsupported container version {version}')
    hdr = int.from_bytes(data[:14], 'little')
    tail_mode = bool((hdr >> 15) & 1)
    rawesc = bool((hdr >> 18) & 1)
    shapewide = bool((hdr >> 19) & 1)
    r = (hdr >> 20) & 0x7F
    shapenarrow = bool((hdr >> 27) & 1)
    sw = 16 if shapewide else (8 if shapenarrow else 12)
    latent_shape = tuple((hdr >> (28 + i * sw)) & ((1 << sw) - 1) for i in range(3))
    sym_crc = (hdr >> (28 + 3 * sw)) & 0xFFFFFFFF
    pos = (28 + 3 * sw + 32 + 7) // 8
    if rawesc:
        if pos + 4 * r > len(data):
            raise ValueError('truncated container (raw states)')
        states = np.frombuffer(data[pos:pos + 4 * r], np.uint32).copy()
        pos += 4 * r
    else:
        states, consumed = _unpack_states(r, data, pos, wide=tail_mode)
        pos += consumed
    k = None
    if tail_mode:
        k, bits = _rice_unpack_bits(r, data, pos, 0)
        if k.min() < 0:
            raise ValueError('corrupt k-table (negative warmup count)')
        pos += (bits + 7) // 8
    if pos > len(data):
        raise ValueError('truncated container (side info)')
    tail = data[pos:]
    if len(tail) % 2:
        raise ValueError('truncated container')
    stream_words = np.frombuffer(tail, np.uint16).astype(np.uint32)
    return latent_shape, stream_words, states, sym_crc, k


def stream_impl_id(data: bytes) -> int:
    if data[:1] != MAGIC:
        raise ValueError('bad magic')
    return (data[1] >> 4) & 0x7


def stream_prec(data: bytes) -> int:
    if data[:1] != MAGIC:
        raise ValueError('bad magic')
    return data[2] & 0x3


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

class MeshHandle(NamedTuple):
    """A batch submitted over several devices: (device, handle) per piece;
    the results past n_real are pad copies."""
    pieces: Tuple
    n_real: int


def _split_padded(items, n: int):
    """Pad a batch (array, tensor or list) to a multiple of n by repeating
    its last element, and split it into n equal pieces."""
    pad = (n - len(items) % n) % n
    if isinstance(items, torch.Tensor):
        items = torch.cat([items] + [items[-1:]] * pad)
    elif isinstance(items, np.ndarray):
        items = np.concatenate([items] + [items[-1:]] * pad)
    else:
        items = list(items) + [items[-1]] * pad
    size = len(items) // n
    return [items[i * size:(i + 1) * size] for i in range(n)]


class LatentCodec:
    """Entropy codec for one (pc_config, num_centers) context model.

    ``impl``: 'auto' codes kernel_size 3 with the K=3 wavefront codec
    ('cuda', coding/cuda_codec.py, id 5) and any other kernel_size with the
    planar codec ('cuda_planar', coding/planar_codec.py, id 6); 'cuda' off
    K=3 becomes 'cuda_planar'. Decode routes each stream on its container's
    impl id, and refuses any id but 5 and 6.

    ``device`` is one device or a list: with several, a batch is padded to
    a multiple of their count by repeating its last image, split into equal
    pieces, each coded on its device (one coder each), and the pad results
    are dropped; the streams are those of the unsplit batch.

    ``prec`` ('f32', 'bf16' or 'f8': the container's prec byte 0, 1, 2) is
    the operand precision of the 'cuda' codec's encode (kernel 2); None reads
    $IMGCOMP_PALLAS_PREC at each encode, f32 when it is unset
    (cuda_codec.encode_prec). A stream decodes at its own precision. The
    planar codec writes precision 0 only, as the JAX package's planar codec
    does: it ignores the variable and refuses another ``prec``."""

    def __init__(self, pc, pc_config, device='cuda', impl: str = 'auto', prec=None):
        from .. import resolve_device
        if impl not in IMPLS:
            raise ValueError(f'unknown impl {impl!r}; expected one of {IMPLS}')
        self.pc, self.pc_config = pc, pc_config
        devices = device if isinstance(device, (list, tuple)) else [device]
        self.devices = [resolve_device(d) for d in devices]
        self.device = self.devices[0]
        k3 = pc_config.kernel_size == 3
        if impl == 'auto':
            impl = 'cuda' if k3 else 'cuda_planar'
        elif impl == 'cuda' and not k3:
            impl = 'cuda_planar'
        self.impl = impl
        self.impl_id = IMPL_IDS[impl]
        if prec is not None:
            from .cuda_kernel import prec_id
            prec = prec_id(prec)
            if prec and impl != 'cuda':
                raise ValueError(f'impl {impl} writes precision 0 (f32) only; precision '
                                 f'{prec} is the K=3 wavefront codec\'s (impl cuda)')
        self.prec = prec
        self._coders = {}

    def coder(self, impl_id: int, device=None):
        """The coder of a port impl id (5 or 6) on ``device`` (default: the
        first); raises for any other id."""
        if impl_id not in (IMPL_CUDA, IMPL_CUDA_PLANAR):
            raise ValueError(
                f'stream impl id {impl_id} ({IMPL_NAMES.get(impl_id, "?")}) is not '
                'decodable by the port (impl cuda, id 5, or cuda_planar, id 6)')
        dev = self.device if device is None else device
        key = (impl_id, str(dev))
        if key not in self._coders:
            if impl_id == IMPL_CUDA:
                from .cuda_codec import CudaCoder
                self._coders[key] = CudaCoder(self.pc, self.pc_config, dev, self.prec)
            else:
                from .planar_codec import PlanarCoder
                self._coders[key] = PlanarCoder(self.pc, self.pc_config, dev)
        return self._coders[key]

    def encode_batch_submit(self, symbols, centers):
        """Enqueue a batch's encode on the current stream and return a handle
        for encode_batch_finish without waiting for the card. symbols (B, C,
        H, W) int: a tensor on the codec's device is range-checked there
        (finish raises), anything else on the host (raises here). centers
        (L,): a host array keeps the submit free of any wait; a CUDA tensor
        costs one read of its values."""
        if len(self.devices) == 1:
            return self.coder(self.impl_id).encode_batch_submit(symbols, centers)
        pieces = _split_padded(symbols, len(self.devices))
        return MeshHandle(tuple((d, self.coder(self.impl_id, d).encode_batch_submit(p, centers))
                                for p, d in zip(pieces, self.devices)), len(symbols))

    def encode_batch_finish(self, handle) -> Tuple[EncodeResult, ...]:
        """Wait for that batch's events only, then serialize its streams."""
        if isinstance(handle, MeshHandle):
            out = [r for d, h in handle.pieces
                   for r in self.coder(h.impl_id, d).encode_batch_finish(h)]
            return tuple(out[:handle.n_real])
        return self.coder(handle.impl_id).encode_batch_finish(handle)

    def encode_batch(self, symbols, centers) -> Tuple[EncodeResult, ...]:
        return self.encode_batch_finish(self.encode_batch_submit(symbols, centers))

    def decode_batch_submit(self, bitstreams, centers):
        """Parse, upload and enqueue a decode through the coder of the
        streams' impl id (one id per batch); returns a handle for
        decode_batch_finish without waiting for the card."""
        ids = {stream_impl_id(bs) for bs in bitstreams}
        if len(ids) != 1:
            raise ValueError(f'mixed impl ids {sorted(ids)} in one decode batch')
        impl_id = ids.pop()
        if len(self.devices) == 1:
            return self.coder(impl_id).decode_batch_submit(bitstreams, centers)
        pieces = _split_padded(list(bitstreams), len(self.devices))
        return MeshHandle(tuple((d, self.coder(impl_id, d).decode_batch_submit(p, centers))
                                for p, d in zip(pieces, self.devices)), len(bitstreams))

    def decode_batch_finish(self, handle, verify: bool = True, device_out: bool = True):
        """-> (B, C, H, W) int32 symbols. device_out=True (the port's
        default) returns the tensor on the codec's (first) device;
        device_out=False returns what the reference returns, a host np.int32
        array. With verify, waits for the batch's events and raises unless
        every image's device-computed checksum matches its container's."""
        from .cuda_codec import finish_decode
        if isinstance(handle, MeshHandle):
            parts = [finish_decode(h, verify, device_out) for _, h in handle.pieces]
            if device_out:
                return torch.cat([p.to(self.device) for p in parts])[:handle.n_real]
            return np.concatenate(parts)[:handle.n_real]
        return finish_decode(handle, verify, device_out)

    def decode_batch(self, bitstreams, centers, verify: bool = True, device_out: bool = True):
        """decode_batch_finish(decode_batch_submit(...)): see there."""
        return self.decode_batch_finish(self.decode_batch_submit(bitstreams, centers),
                                        verify, device_out)

    def encode(self, symbols_chw, centers) -> EncodeResult:
        """One (C, H, W) volume through the B=1 batch path."""
        return self.encode_batch(symbols_chw[None], centers)[0]

    def decode(self, bitstream: bytes, centers, verify: bool = True) -> np.ndarray:
        """One stream -> (C, H, W) np.int32 symbols on the host."""
        return self.decode_batch([bitstream], centers, verify=verify, device_out=False)[0]

    def roundtrip(self, symbols_chw, centers) -> EncodeResult:
        """Encode, decode and assert a bit-exact recovery of a host (C, H, W)
        volume (the reference's oracle, ref bit_counter.py:68)."""
        result = self.encode(symbols_chw, centers)
        decoded = self.decode(result.bitstream, centers)
        np.testing.assert_array_equal(np.asarray(symbols_chw, np.int32), decoded)
        return result
