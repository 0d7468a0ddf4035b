"""The comparison that decides ``correct`` for the codec's cells.

What the timed window produced (a sample of its batches or requests, drawn
from the seed, the longest among them) is held to the plain reference
(reference/cvpr.py), computed anew from the same images and weights in
float32 with TF32 off, a few images at a time:

- ``sym_mismatch_max``: the worst image's share of decoded symbols that
  differ from the reference encoder's (AE towers, importance map, kernel 1,
  and the whole entropy round trip);
- ``roundtrip_errors``: decoded symbols that differ from the symbols the
  window encoded (exact: limit 0);
- ``theo_gap_max``: the worst image's |program bits / reference bits - 1|,
  where bits are the sum of -log2(freq / 2^16) that the program's encode
  reports and that the reference's context model and 16-bit CDF give the
  same symbols (kernels 2 and 5, the bias rows, the CDF);
- ``recon_rms_max``: the worst image's root-mean-square difference, in
  pixel levels, of the program's reconstruction from the reference
  decoder's on the decoded symbols (AE decoder).

The control puts the reference in the program's place one precision step
below the configuration's: AE convolutions in float8 e4m3 (the step below
bfloat16) and the context model in TF32 (below float32 with TF32 off).
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple

import torch

from perfbench.reference import cvpr as ref

CHUNK = 8


class Sample(NamedTuple):
    x: torch.Tensor          # (b, H, W, 3) uint8 inputs
    syms_enc: torch.Tensor   # (b, C, h, w) symbols the window encoded
    syms_dec: torch.Tensor   # (b, C, h, w) symbols the window decoded
    theo: torch.Tensor       # (b,) float64 bits the encode reported
    x_out: torch.Tensor      # (b, H, W, 3) reconstruction (float32 or uint8)


def _pad_value(cfg: Dict, centers: torch.Tensor) -> float:
    return float(centers[0]) if cfg['model']['use_centers_for_padding'] else 0.0


def _clock(timing, key, t0, device):
    """Add the seconds since t0 to timing[key] (synchronized); -> now."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    timing[key] = timing.get(key, 0.0) + t - t0
    return t


def numbers(cfg: Dict, weights, samples: List[Sample], timing=None) -> Dict[str, float]:
    """The check's numbers over ``samples``; ``timing`` (a dict), when
    given, gathers the reference's seconds by stage."""
    timing = {} if timing is None else timing
    m = cfg['model']
    blocks, k = m['arch_param_B'], m['kernel_size']
    centers = weights.ae['encoder.centers']
    pad = _pad_value(cfg, centers)
    mism, rt, gap, rms = 0.0, 0, 0.0, 0.0
    with torch.no_grad(), ref.tf32(False):
        for s in samples:
            for i in range(0, s.x.shape[0], CHUNK):
                sl = slice(i, i + CHUNK)
                dev = centers.device
                t = _clock(timing, 'move', time.perf_counter(), dev)
                dec = s.syms_dec[sl].to(dev).long()
                t = _clock(timing, 'move', t, dev)
                _, ref_syms = ref.ae_encode(weights.ae, s.x[sl].to(dev), blocks)
                t = _clock(timing, 'ae_encode', t, dev)
                mism = max(mism, float((dec != ref_syms).float().mean((1, 2, 3)).max()))
                rt += int((dec != s.syms_enc[sl].to(dec.device).long()).sum())
                t = _clock(timing, 'compare', t, dev)
                bits = ref.stream_entropy_bits(weights.pc, centers, dec, k, pad)
                t = _clock(timing, 'context_model', t, dev)
                gap = max(gap, float((s.theo[sl].to(bits.device) / bits - 1).abs().max()))
                ref_x = ref.ae_decode(weights.ae, centers[dec], blocks)
                t = _clock(timing, 'ae_decode', t, dev)
                out = s.x_out[sl].to(ref_x.device)
                if out.dtype == torch.uint8:
                    ref_x = ref_x.to(torch.uint8)
                d = out.float() - ref_x.float()
                rms = max(rms, float(torch.sqrt(torch.mean(d * d, (1, 2, 3))).max()))
                _clock(timing, 'compare', t, dev)
    return {'sym_mismatch_max': mism, 'roundtrip_errors': rt, 'theo_gap_max': gap,
            'recon_rms_max': rms}


def control_sample(cfg: Dict, weights, x: torch.Tensor, file_output: bool = False) -> Sample:
    """The reference one precision step below the configuration's, in the
    program's place, on images ``x``."""
    m = cfg['model']
    blocks, k = m['arch_param_B'], m['kernel_size']
    centers = weights.ae['encoder.centers']
    pad = _pad_value(cfg, centers)
    syms, theo, outs = [], [], []
    with torch.no_grad(), ref.tf32(False):
        for i in range(0, x.shape[0], CHUNK):
            _, s = ref.ae_encode(weights.ae, x[i:i + CHUNK], blocks, prec='fp8')
            syms.append(s)
            theo.append(ref.stream_entropy_bits(weights.pc, centers, s, k, pad, prec='tf32'))
            y = ref.ae_decode(weights.ae, centers[s], blocks, prec='fp8')
            outs.append(y.to(torch.uint8) if file_output else y)
    s = torch.cat(syms)
    return Sample(x, s, s, torch.cat(theo), torch.cat(outs))


def run_numbers(ctx, samples: List[Sample], timing=None) -> Dict[str, float]:
    """A codec runner's ``numbers``: the check's numbers over the window's
    samples, with the weights and configuration of its context ``ctx``."""
    return numbers(ctx.cfg, ctx.weights, samples, timing)


def run_control_numbers(ctx, samples: List[Sample]) -> Dict[str, float]:
    """A codec runner's ``control_numbers``: the check's numbers for the
    control on the samples' images."""
    ctrl = [control_sample(ctx.cfg, ctx.weights, s.x.to(ctx.device),
                           file_output=s.x_out.dtype == torch.uint8)
            for s in samples]
    return numbers(ctx.cfg, ctx.weights, ctrl)
