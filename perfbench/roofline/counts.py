"""Operations and bytes of the work the codec's algorithm needs, from shapes.

Counts are of multiply-adds (2 operations each) of the convolutions only;
BatchNorm, ReLU, softmax and the coder's integer work are left out, so the
counts are a floor. A convolution counts only the (output, tap) pairs whose
tap lands on a real input, not on SAME padding; a masked convolution counts
only the taps its causal mask keeps. The count is the same whatever
implements the work. Bytes count each input byte read once and each output
byte written once. ``peaks.json`` holds the card's published peaks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'peaks.json')


def peaks() -> Dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def same_pad_lo(n: int, k: int, s: int) -> int:
    out = -(-n // s)
    return max((out - 1) * s + k - n, 0) // 2


def pairs_conv(n_in: int, k: int, s: int) -> int:
    """(output, tap) pairs of a TF 'SAME' convolution along one axis whose
    tap reads a real input."""
    lo = same_pad_lo(n_in, k, s)
    return sum(1 for o in range(-(-n_in // s)) for t in range(k) if 0 <= o * s + t - lo < n_in)


def pairs_conv_transpose(n_in: int, k: int, s: int) -> int:
    """(input, tap) pairs of a TF 'SAME' transposed convolution (output
    n_in * s) whose output lands inside the cropped result."""
    n_out = n_in * s
    lo = same_pad_lo(n_out, k, s)
    return sum(1 for i in range(n_in) for t in range(k) if 0 <= i * s + t - lo < n_out)


def ae_layers(h: int, w: int, c_bn: int, blocks: int, n: int = 128) -> List[Tuple]:
    """(name, cin, cout, k, stride, transpose, input h, input w) of every
    convolution of the CVPR autoencoder on an h x w image."""
    res = (blocks * 3 + 1) * 2
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    enc = [('h1', 3, n // 2, 5, 2, False, h, w), ('h2', n // 2, n, 5, 2, False, h2, w2)]
    enc += [('enc_res', n, n, 3, 1, False, h4, w4)] * res
    enc += [('to_bn', n, c_bn + 1, 5, 2, False, h4, w4)]
    dec = [('from_bn', c_bn, n, 3, 2, True, h8, w8)]
    dec += [('dec_res', n, n, 3, 1, False, h4, w4)] * res
    dec += [('h12', n, n // 2, 5, 2, True, h4, w4), ('h13', n // 2, 3, 5, 2, True, h2, w2)]
    return enc, dec


def conv_flops(layer) -> int:
    _, cin, cout, k, s, tr, h, w = layer
    pairs = pairs_conv_transpose if tr else pairs_conv
    return 2 * pairs(h, k, s) * pairs(w, k, s) * cin * cout


def ae_flops(h: int, w: int, c_bn: int, blocks: int) -> Tuple[int, int]:
    """(encoder, decoder) operations of one h x w image."""
    enc, dec = ae_layers(h, w, c_bn, blocks)
    return sum(map(conv_flops, enc)), sum(map(conv_flops, dec))


def kept_taps(k: int, first: bool, current_slice_only: bool = False) -> int:
    """Taps a causal (kd, k, k) mask keeps: the kd - 1 earlier slices whole,
    and in the current slice the rows above and the centre row's left part
    (with the centre, except in the first layer)."""
    c = k // 2
    current = c * k + (c if first else c + 1)
    return current if current_slice_only else (k // 2) * k * k + current


def cm_flops_per_symbol(k: int, kf: int, L: int, current_slice_only: bool = False) -> int:
    """Operations of the context model's four masked layers at one symbol."""
    t1 = kept_taps(k, True, current_slice_only)
    t = kept_taps(k, False, current_slice_only)
    return 2 * (t1 * kf + 2 * t * kf * kf + t * kf * L)


def cm_weight_bytes(k: int, kf: int, L: int) -> int:
    kd = k // 2 + 1
    return 4 * (kd * k * k * (kf + 2 * kf * kf + kf * L) + 3 * kf + L)


def entropy_pass(symbols: int, k: int, kf: int, L: int, words: int, encode: bool,
                 current_slice_only: bool = False) -> Tuple[int, int]:
    """(operations, bytes) of one pass of the context model over ``symbols``
    symbols with its CDFs: an encode reads the int32 symbols and writes each
    symbol's int32 frequency and start; a decode reads the 16-bit stream
    words and writes the int32 symbols."""
    flops = symbols * cm_flops_per_symbol(k, kf, L, current_slice_only)
    io = symbols * (4 + 8) if encode else 2 * words + 4 * symbols
    return flops, io + cm_weight_bytes(k, kf, L)


def bound_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of the operation and
    the byte bounds."""
    return max(flops / flops_peak, nbytes / (peaks()['hbm_tb_per_s'] * 1e12))


def codec_work(cfg: Dict, h: int, w: int, images: int, words: float) -> Dict[str, float]:
    """Least device seconds of one unit of the codec's work (``images``
    images of h x w, ``words`` 16-bit stream words) at the card's peaks:
    ``step_min_s`` the whole step (AE encode and decode at the towers'
    precision, the context model's encode and decode passes at float32) and
    the entropy kernel's bound, ``k2_bound_s`` (kernel 2 computes every
    masked tap) or ``k5_bound_s`` (kernel 5 only the current plane's; the
    bias rows compute the earlier planes')."""
    m, pk = cfg['model'], peaks()
    k, kf, L = m['kernel_size'], m['arch_param__k'], m['num_centers']
    enc, dec = ae_flops(h, w, m['num_chan_bn'], m['arch_param_B'])
    ae_peak = pk['bf16_tflops' if cfg['serve']['ae_dtype'] == 'bf16' else 'f32_tflops'] * 1e12
    f32 = pk['f32_tflops'] * 1e12
    syms = images * m['num_chan_bn'] * (h // 8) * (w // 8)
    out = {'step_min_s': images * (enc + dec) / ae_peak
           + 2 * syms * cm_flops_per_symbol(k, kf, L) / f32}
    plane_only = k != 3
    e = entropy_pass(syms, k, kf, L, words, True, plane_only)
    d = entropy_pass(syms, k, kf, L, words, False, plane_only)
    out['k5_bound_s' if plane_only else 'k2_bound_s'] = bound_s(*e, f32) + bound_s(*d, f32)
    return out
