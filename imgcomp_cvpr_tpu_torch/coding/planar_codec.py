"""The planar (per-depth-plane) codec on the card, for any
kernel_size (counterpart of imgcomp_cvpr_tpu/coding/planar_codec.py::
PlanarCoder at bsub = 1, container precision 0).

Decode, per plane d = 0..C-1: the bias rows of the four layers (the lower
kernel slices over the kd-1 known planes below d, plus the layer bias), then
kernel 5's scan over the plane, with the rANS state and read pointer carried
across planes and the plane's own pull threshold thresh - d * plane_tot;
then the CRC is checked on the device. Planes below 0 are the all-pad
constants (pad value for q, k1..k3 for the hidden layers).

Encode is teacher-forced, so it goes level by level instead: for level l =
1..4 the bias rows of all C planes (they read level l-1 of the planes below,
complete after the pass before), then ONE kernel-5 launch over the level's
cells of all (image, plane) pairs, then one launch for the (freq, start)
tables: 5 kernel-5 launches a batch, whatever C. Then kernel 6 over all
(plane, step) rows (x0 = 1 tail packing when the longest lane reaches
TAIL_MIN_LANE_SYMBOLS; a lane whose warmup exceeds K_CAP sends the batch back
through kernel 6 with x0 = RANS_L). ``encode_tables_scan`` keeps the
plane-by-plane teacher-forced scan as the consistency oracle.

Submit / finish as in cuda_codec (counterpart planar_codec.py:621-839):
submit enqueues and returns, finish waits for its batch's event only.

The bias rows come from coding/bias_rows.py: one launch a level in encode
(all B x C pairs), one a plane in decode (all four levels of every image),
each the span ``planar.bias_rows`` and one count of
``build.LAUNCHES['bias_rows']``. Each row is a fixed chain of sums of one
image's data, whatever the batch or the launch, so every float that feeds a
CDF is too, and a stream decodes alone exactly as it was encoded in a batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import probclass as pc_lib
from ..utils.spans import span
from . import bias_rows as br
from . import codec as codec_lib
from . import cuda_codec
from . import planar
from . import planar_kernel as pk


class PlanarFold(NamedTuple):
    top: pk.PlaneWeights                  # kernel 5's top-slice taps
    low: Tuple[torch.Tensor, ...]         # per layer (kd-1, K, K, cin, cout)
    bias: Tuple[torch.Tensor, ...]        # per layer (cout,)
    consts: Tuple[torch.Tensor, ...]      # k1..k3, each (kf,) f32
    pad: float


def fold_planar(pc: pc_lib.ProbClassifier, centers: torch.Tensor) -> PlanarFold:
    """Top-slice taps -> kernel weights; lower slices w[:kd-1] -> the
    bias-row kernel's (kd-1, K, K, cin, cout), oldest plane first
    (planar_codec.py:234-258); the all-pad constants in float64."""
    net = pc.net
    K = net.kernel_size
    kd = pc_lib.filter_depth(K)
    dev = centers.device
    tops, lows, bs = [], [], []
    for i, conv in enumerate((net.conv0, net.res1.conv1, net.res1.conv2, net.conv_out)):
        w = conv.weight.detach().float()                 # (cout, cin, kd, K, K)
        tops.append(torch.stack([w[:, :, kd - 1, dy, dx].t()
                                 for dy, dx in planar.unmasked_taps(K, i == 0)]).to(dev).contiguous())
        lows.append(w[:, :, :kd - 1].permute(2, 3, 4, 1, 0).to(dev).contiguous())
        bs.append(conv.bias.detach().float().to(dev).contiguous())
    pad = float(pc_lib.auto_pad_value(pc.config, centers, pc))
    consts = tuple(k.float().to(dev) for k in cuda_codec.pad_constants(pc, pad))
    top = pk.PlaneWeights(*tops, torch.full((1,), pad, dtype=torch.float32, device=dev),
                          centers.detach().float().contiguous())
    return PlanarFold(top, tuple(lows), tuple(bs), consts, pad)


class PlanarCoder:
    """Entropy codec for one context model of any kernel_size, plane by
    plane on the card (kernels 5 and 6); on the CPU the kernels' plain
    versions run."""

    def __init__(self, pc: pc_lib.ProbClassifier, pc_config, device='cuda'):
        self.device = resolve_device(device)
        self.pc = pc
        self.K = pc_config.kernel_size
        self.L = pc.num_centers
        self._folds = cuda_codec.FoldCache(fold_planar)
        self._cols = {}        # latent shape -> stream words to copy at submit

    def _prepare(self, latent_shape, centers):
        return (planar.build_planar_schedule(tuple(latent_shape), self.K),
                self._folds.get(self.pc, centers, self.device))

    def lane_totals(self, latent_shape) -> np.ndarray:
        """(R,) active symbols per rANS lane over the whole volume."""
        sched = planar.build_planar_schedule(tuple(latent_shape), self.K)
        return (latent_shape[0] * planar.plane_totals(sched)).astype(np.int32)

    # -- the plane loop -------------------------------------------------------

    def _history(self, fold: PlanarFold, sched, b: int) -> br.History:
        """The kd-1 planes below plane 0 of each level 0..3: all constants."""
        return br.history(b, sched.grids, pc_lib.filter_depth(self.K))

    @staticmethod
    def bias_rows(fold: PlanarFold, hist: br.History) -> Tuple[torch.Tensor, ...]:
        """The next plane's 4 bias rows (b, Hl, Wl, cout): sum_j
        conv2d(act_{l-1}[d-kd+1+j], w_l[j]) + b_l, in one call."""
        with span('planar.bias_rows'):
            return br.plane_rows(fold, hist)

    @staticmethod
    def _push(hist: br.History, out: pk.PlaneOut) -> None:
        br.push(hist, out.q, out.acts)

    # -- encode ---------------------------------------------------------------

    def encode_tables(self, syms: torch.Tensor, fold: PlanarFold, plain: bool = False,
                      return_logits: bool = False):
        """(B, C, H, W) int32 symbols -> (fsel, ssel) (B, C*T2, R) int32 in
        (plane, step) coding order, through kernel 5's layer-parallel encode:
        per level the bias rows of all planes, then one launch. ``plain``
        runs kernel 5's plain versions instead, whatever the device (the
        bias rows stay those of the wrapper, so the two share them).
        ``return_logits`` also returns level 4's (B*C, H, W, L) logits."""
        level = pk.level_forward_plain if plain else pk.level_forward
        b, C, H, W = syms.shape
        latent_shape = (C, H, W)
        sched = planar.build_planar_schedule(latent_shape, self.K)
        reach = planar.geometry(self.K)[1]
        q = torch.full((b, C) + sched.grids[0], fold.pad, dtype=torch.float32,
                       device=syms.device)
        q[:, :, reach:reach + H, reach:reach + W] = fold.top.centers[syms.long()]
        src = q.reshape((b * C,) + sched.grids[0])        # the kernels' input
        act1 = None
        for l in range(4):
            with span('planar.bias_rows'):
                bias = br.level_rows(fold, l + 1, src, C)
            out = level(l + 1, fold.top, latent_shape, self.K, src, bias,
                        skip=act1 if l == 2 else None)
            if l == 0:
                act1 = out
            src = out
        true = syms.reshape(b * C, H, W).contiguous()
        if plain:
            fsel, ssel = pk.plane_tables_plain(out, true, latent_shape, self.K)
        else:
            fsel, ssel = pk.plane_tables(fold.top, out, true, latent_shape, self.K)
        tables = fsel.reshape(b, -1, planar.R), ssel.reshape(b, -1, planar.R)
        return (tables, out) if return_logits else tables

    def encode_tables_scan(self, syms: torch.Tensor, fold: PlanarFold):
        """encode_tables through kernel 5's teacher-forced scan, plane by
        plane: the consistency oracle of the layer-parallel encode (the
        tables are equal)."""
        b, C = syms.shape[:2]
        latent_shape = tuple(int(v) for v in syms.shape[1:])
        sched = planar.build_planar_schedule(latent_shape, self.K)
        hist = self._history(fold, sched, b)
        fsel = torch.empty(b, C, sched.T2, planar.R, dtype=torch.int32, device=syms.device)
        ssel = torch.empty_like(fsel)
        for d in range(C):
            out = pk.plane_forward(pk.MODE_ENCODE, fold.top, latent_shape, self.K,
                                   self.bias_rows(fold, hist),
                                   true_plane=syms[:, d].contiguous())
            fsel[:, d], ssel[:, d] = out.fsel, out.ssel
            self._push(hist, out)
        return fsel.reshape(b, -1, planar.R), ssel.reshape(b, -1, planar.R)

    def encode_batch_submit(self, symbols, centers) -> cuda_codec.EncodeHandle:
        """Enqueue an encode (kernel 5's level passes with their bias rows,
        kernel 6, the checksums, the theoretical bits, the copies to pinned
        buffers) without waiting for the card; as CudaCoder's."""
        syms, host_syms, bad = cuda_codec.device_symbols(symbols, self.L, self.device)
        latent_shape = tuple(int(v) for v in syms.shape[1:])
        _, fold = self._prepare(latent_shape, centers)
        fsel, ssel = self.encode_tables(syms, fold)
        tail = int(self.lane_totals(latent_shape).max()) >= codec_lib.TAIL_MIN_LANE_SYMBOLS
        return cuda_codec.submit_encode(
            latent_shape, codec_lib.IMPL_CUDA_PLANAR, self.L,
            lambda x0: pk.plane_reverse(fsel, ssel, latent_shape, self.K, x0), tail,
            cuda_codec.theoretical_bits(fsel, _active(latent_shape, self.K, str(self.device))),
            cuda_codec.checksums(syms.reshape(syms.shape[0], -1)), bad, host_syms,
            self._cols.get(latent_shape))

    def encode_batch_finish(self, handle: cuda_codec.EncodeHandle
                            ) -> Tuple[codec_lib.EncodeResult, ...]:
        return cuda_codec.finish_encode(handle, self._cols)

    def encode_batch(self, symbols, centers) -> Tuple[codec_lib.EncodeResult, ...]:
        """symbols: (B, C, H, W) int, a tensor (any device) or numpy."""
        return self.encode_batch_finish(self.encode_batch_submit(symbols, centers))

    # -- decode ---------------------------------------------------------------

    def decode_batch_submit(self, bitstreams: Sequence[bytes], centers
                            ) -> cuda_codec.DecodeHandle:
        """Parse on the host, upload without waiting, enqueue the plane loop
        (bias rows and kernel 5's scan a plane) and the checksums."""
        pb = cuda_codec.parse_batch(
            bitstreams,
            lambda s: planar.build_planar_schedule(tuple(s), self.K).stream_cap,
            self.lane_totals)
        latent_shape = tuple(pb.latent_shape)
        C, H, W = latent_shape
        sched, fold = self._prepare(latent_shape, centers)
        dev = self.device
        b = len(pb.crcs)
        streams, states, thresh = cuda_codec.upload_parsed(pb, sched.stream_cap, dev)
        gptr = torch.zeros(b, dtype=torch.int32, device=dev)
        plane_tot = _plane_totals(latent_shape, self.K, str(dev))
        syms = torch.empty(b, C, H, W, dtype=torch.int32, device=dev)
        hist = self._history(fold, sched, b)
        for d in range(C):
            # The kernel counts a lane's symbols within one plane, so plane
            # d's threshold is the global one minus the d planes before it.
            out = pk.plane_forward(pk.MODE_DECODE, fold.top, latent_shape, self.K,
                                   self.bias_rows(fold, hist), streams=streams,
                                   states=states, gptr=gptr,
                                   thresh=(thresh - d * plane_tot).int().contiguous())
            syms[:, d], states, gptr = out.syms, out.states, out.gptr
            self._push(hist, out)
        return cuda_codec.submit_checks(syms, pb.crcs)

    def decode_batch_finish(self, handle: cuda_codec.DecodeHandle, verify: bool = True,
                            device_out: bool = True):
        return cuda_codec.finish_decode(handle, verify, device_out)

    def decode_batch(self, bitstreams: Sequence[bytes], centers, verify: bool = True,
                     device_out: bool = True):
        """-> (B, C, H, W) int32 symbols (see cuda_codec.finish_decode)."""
        return self.decode_batch_finish(self.decode_batch_submit(bitstreams, centers),
                                        verify, device_out)


@functools.lru_cache(maxsize=8)
def _active(latent_shape, K: int, device: str) -> torch.Tensor:
    """(C * T2, R) bool activity of the (plane, step) rows on ``device``."""
    return torch.from_numpy(pk._full_active(planar.build_planar_schedule(latent_shape, K))
                            ).to(device)


@functools.lru_cache(maxsize=8)
def _plane_totals(latent_shape, K: int, device: str) -> torch.Tensor:
    return torch.from_numpy(planar.plane_totals(planar.build_planar_schedule(latent_shape, K))
                            ).to(device)
