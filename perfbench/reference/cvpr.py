"""Plain PyTorch reference of the CVPR-2018 learned image codec (Mentzer et
al., "Conditional Probability Models for Deep Image Compression"; the
published code is fab-jul/imgcomp-cvpr): the autoencoder with its importance
map and nearest-center quantizer, the masked-3D-conv context model, and the
16-bit CDF that the entropy coder codes with.

Written from the published model, in float32 with TF32 off, with no kernel,
cache or batching trick. It imports nothing of the program under test: the
weights come from the raw npz file or from the benchmark's own generator as
plain dicts of tensors (``ae_params`` / ``pc_params``).

``prec`` selects the arithmetic of the convolutions: 'f32' (the reference)
or one step below a configuration's precision for the control: 'fp8' (each
convolution's input and weight rounded to float8 e4m3 with a per-tensor
scale, the step below bfloat16) and 'tf32' (each convolution's input and
weight rounded to TF32's 10-bit mantissa, the step below float32 with TF32
off; rounded here, since cuDNN picks TF32 kernels for some shapes only).
The products are then summed in float32 either way.

Layout: images NHWC in [0, 255]; latents (N, C, H, W); AE convolution
weights in F.conv2d's OIHW layout (transposed convolutions IOHW); context
model weights (cout, cin, kd, k, k).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SCALE = 1 << 16            # the entropy coder's frequency total
BN_EPS = 1e-5
NORM_MEAN = (121.85369873, 113.58860779, 100.63715363)
NORM_VAR = (4746.37695312, 4454.13964844, 4812.234375)
E4M3_MAX = 448.0


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuDNN and cuBLAS TF32 set to ``enabled`` inside the block."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with the per-tensor scale amax / 448, back in
    float32."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (float32 with a 10-bit mantissa), to nearest even."""
    i = t.float().contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def _operands(x, w, prec):
    """The convolution's operands at ``prec``; the rounding passes the
    gradient straight through, so the backward convolutions also see the
    rounded operands."""
    rnd = {'fp8': round_fp8, 'tf32': round_tf32}.get(prec)
    if rnd is None:
        return x, w
    return tuple(t + (rnd(t.detach()) - t).detach() for t in (x, w))


# ---------------------------------------------------------------------------
# Autoencoder
# ---------------------------------------------------------------------------

def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF 'SAME' padding (lo, hi) of one spatial dimension."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x, w, stride, prec):
    """NCHW x OIHW, TF 'SAME'."""
    k = w.shape[2]
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    x, w = _operands(x, w, prec)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def conv_transpose_same(x, w, stride, prec):
    """NCHW x IOHW, TF 'SAME' (output = input * stride): the full transposed
    convolution cropped by the forward convolution's low padding."""
    k = w.shape[2]
    h, wd = x.shape[2] * stride, x.shape[3] * stride
    ph, pw = same_pads(h, k, stride)[0], same_pads(wd, k, stride)[0]
    x, w = _operands(x, w, prec)
    y = F.conv_transpose2d(x, w, stride=stride)
    return y[:, :, ph:ph + h, pw:pw + wd]


def slim(p: Dict, name: str, x, stride=1, act=True, transpose=False, prec='f32'):
    """conv (no bias) -> BatchNorm with the running statistics -> ReLU."""
    w = p[name + '.w']
    y = (conv_transpose_same if transpose else conv_same)(x, w, stride, prec)
    mul = torch.rsqrt(p[name + '.var'] + BN_EPS) * p[name + '.scale']
    y = (y - p[name + '.mean'][:, None, None]) * mul[:, None, None] + p[name + '.bias'][:, None, None]
    return torch.relu(y) if act else y


def res_block(p, name, x, act=True, prec='f32'):
    y = slim(p, name + '.conv1', x, act=act, prec=prec)
    return slim(p, name + '.conv2', y, act=False, prec=prec) + x


def _norm(device):
    mean = torch.tensor(NORM_MEAN, dtype=torch.float32, device=device)
    std = torch.sqrt(torch.tensor(NORM_VAR, dtype=torch.float64) + 1e-10).float().to(device)
    return mean, std


def ae_encode(p: Dict, x_nhwc: torch.Tensor, blocks: int, prec='f32'):
    """(N, H, W, 3) images in [0, 255] -> (z (N, C, H/8, W/8) after the
    importance map, symbols (N, C, H/8, W/8) int64: the nearest center, the
    lowest index on a tie)."""
    mean, std = _norm(x_nhwc.device)
    net = ((x_nhwc.float() - mean) / std).permute(0, 3, 1, 2)
    net = slim(p, 'encoder.h1', net, stride=2, prec=prec)
    net = slim(p, 'encoder.h2', net, stride=2, prec=prec)
    res0 = net
    for b in range(blocks):
        res_b = net
        for i in range(3):
            net = res_block(p, f'encoder.res_block_enc_{b}_{i + 1}', net, prec=prec)
        net = net + res_b
    net = res_block(p, 'encoder.res_block_enc_final', net, act=False, prec=prec) + res0
    net = slim(p, 'encoder.to_bn', net, stride=2, act=False, prec=prec)
    c = net.shape[1] - 1
    heat = torch.sigmoid(net[:, :1]) * c
    mask = torch.clamp(heat - torch.arange(c, dtype=net.dtype, device=net.device)[None, :, None, None],
                       0.0, 1.0)
    z = mask * net[:, 1:]
    centers = p['encoder.centers']
    dist = torch.square(z[..., None] - centers)
    return z, torch.argmin(dist, dim=-1)


def ae_decode(p: Dict, q_nchw: torch.Tensor, blocks: int, prec='f32'):
    """(N, C, h, w) center values -> (N, 8h, 8w, 3) images clipped to [0, 255]."""
    net = slim(p, 'decoder.from_bn', q_nchw.float(), stride=2, transpose=True, prec=prec)
    res0 = net
    for b in range(blocks):
        res_b = net
        for i in range(3):
            net = res_block(p, f'decoder.res_block_dec_{b}_{i + 1}', net, prec=prec)
        net = net + res_b
    net = res_block(p, 'decoder.dec_after_res', net, act=False, prec=prec) + res0
    net = slim(p, 'decoder.h12', net, stride=2, transpose=True, prec=prec)
    net = slim(p, 'decoder.h13', net, stride=2, act=False, transpose=True, prec=prec)
    mean, std = _norm(net.device)
    return torch.clamp(net.permute(0, 2, 3, 1) * std + mean, 0.0, 255.0)


# ---------------------------------------------------------------------------
# Context model
# ---------------------------------------------------------------------------

def causal_mask(k: int, first: bool) -> torch.Tensor:
    """(kd, k, k) mask: every earlier depth slice whole; in the current
    slice the rows above and, on the centre row, the columns left of the
    centre (and the centre itself except in the first layer)."""
    kd = k // 2 + 1
    m = torch.ones(kd, k, k)
    c = k // 2
    m[-1, c, c if first else c + 1:] = 0.0
    m[-1, c + 1:, :] = 0.0
    return m


def cm_logits(p: Dict, q_nchw: torch.Tensor, pad_value: float, k: int, prec='f32'):
    """(N, C, H, W) center values -> (N, L, C, H, W) logits of every symbol
    given the symbols before it. The volume is padded with ``pad_value``:
    context_size // 2 planes in front, context_size // 2 on each side in H
    and W; four VALID masked convolutions (ReLU on all but the residual
    block's second) with a residual skip around the block."""
    cs = 4 * (k - 1) + 1
    pad = cs // 2
    vol = F.pad(q_nchw.float() - pad_value, (pad, pad, pad, pad, pad, 0)) + pad_value

    def conv(x, name, first):
        x, w = _operands(x, p[name + '.w'] * causal_mask(k, first).to(x.device), prec)
        return F.conv3d(x, w, p[name + '.b'])
    with tf32(False):
        l1 = torch.relu(conv(vol[:, None], 'conv0', True))
        l2 = torch.relu(conv(l1, 'res1.conv1', False))
        dd, ds = 2 * (k // 2), k - 1
        l3 = conv(l2, 'res1.conv2', False) + l1[:, :, dd:, ds:-ds, ds:-ds]
        return torch.relu(conv(l3, 'conv_out', False))


def symbol_freqs(logits: torch.Tensor, symbols: torch.Tensor) -> torch.Tensor:
    """(N, L, ...) logits and (N, ...) symbols -> the 16-bit frequency of
    each symbol: softmax, floor(p (2^16 - L)) + 1 for every symbol, the
    remainder of 2^16 to the most probable one (the lowest index on a tie)."""
    L = logits.shape[1]
    p = torch.softmax(logits.float(), dim=1)
    freq = torch.floor(p * float(SCALE - L)) + 1
    deficit = SCALE - freq.sum(1, keepdim=True)
    top = torch.argmax(p, dim=1, keepdim=True)
    freq = freq + torch.where(torch.arange(L, device=p.device)[None, :, None, None, None] == top,
                              deficit, 0.0)
    return torch.gather(freq, 1, symbols[:, None].long())[:, 0]


def stream_entropy_bits(p: Dict, centers: torch.Tensor, symbols: torch.Tensor, k: int,
                        pad_value: float, prec='f32') -> torch.Tensor:
    """(N, C, H, W) symbols -> (N,) float64 bits that the 16-bit frequencies
    give them: sum of -log2(freq / 2^16)."""
    logits = cm_logits(p, centers[symbols.long()], pad_value, k, prec)
    f = symbol_freqs(logits, symbols).double()
    return (-torch.log2(f / SCALE)).sum((1, 2, 3))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def load_npz(path: str, device) -> Tuple[Dict, Dict]:
    """A flax tree saved as one npz entry per leaf -> (ae_params, pc_params)
    in the layouts above. AE: '<encoder|decoder>.<module path>.w / scale /
    bias / mean / var' and 'encoder.centers'; context model:
    '<module>.w / b'."""
    ae, pc = {}, {}
    with np.load(path) as z:
        for key in z.files:
            a = torch.from_numpy(np.array(z[key], np.float32))
            parts = key.split('/')
            if parts[:2] == ['params', 'ae']:
                mod, leaf = parts[2:-1], parts[-1]
                if leaf == 'centers':
                    ae['encoder.centers'] = a
                elif leaf == 'w':
                    tr = mod[0] == 'decoder' and mod[-1] in ('from_bn', 'h12', 'h13')
                    ae['.'.join(mod) + '.w'] = a.permute((2, 3, 0, 1) if tr else (3, 2, 0, 1))
                else:                                   # BatchNorm_0 / scale, bias
                    ae['.'.join(mod[:-1]) + '.' + leaf] = a
            elif parts[0] == 'batch_stats':             # <tree>/BatchNorm_0/mean, var
                ae['.'.join(parts[1:-2]) + '.' + parts[-1]] = a
            elif parts[:2] == ['params', 'pc']:
                mod, leaf = parts[2:-1], parts[-1]
                ae_key = '.'.join(mod) + '.' + leaf
                pc[ae_key] = a.permute(4, 3, 0, 1, 2) if leaf == 'w' else a
            else:
                raise KeyError(f'unmapped npz leaf {key}')
    to = lambda d: {k: v.contiguous().to(device) for k, v in d.items()}  # noqa: E731
    return to(ae), to(pc)


def glorot_limit(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def bn_train(y, scale, bias):
    """BatchNorm with the batch's mean and biased variance E[y^2] - E[y]^2
    (clipped at 0)."""
    mean = y.mean((0, 2, 3))
    var = torch.clamp(torch.square(y).mean((0, 2, 3)) - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + BN_EPS) * scale
    return (y - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]


def slim_train(p, name, x, stride=1, act=True, transpose=False, prec='f32'):
    w = p[name + '.w']
    y = (conv_transpose_same if transpose else conv_same)(x, w, stride, prec)
    y = bn_train(y, p[name + '.scale'], p[name + '.bias'])
    return torch.relu(y) if act else y


def res_block_train(p, name, x, act=True, prec='f32'):
    y = slim_train(p, name + '.conv1', x, act=act, prec=prec)
    return slim_train(p, name + '.conv2', y, act=False, prec=prec) + x


def ae_train(p: Dict, x_nhwc: torch.Tensor, blocks: int, prec='f32'):
    """The autoencoder's training forward: BatchNorm on batch statistics,
    soft-to-hard quantization qbar = qsoft + stop_gradient(qhard - qsoft)
    with qsoft = softmax(-(z - c)^2) . c, and the decoder on qbar. ->
    (qbar (N, C, h, w), symbols, importance mask (N, C, h, w), x_out NHWC)."""
    mean, std = _norm(x_nhwc.device)
    net = ((x_nhwc.float() - mean) / std).permute(0, 3, 1, 2)
    net = slim_train(p, 'encoder.h1', net, stride=2, prec=prec)
    net = slim_train(p, 'encoder.h2', net, stride=2, prec=prec)
    res0 = net
    for b in range(blocks):
        res_b = net
        for i in range(3):
            net = res_block_train(p, f'encoder.res_block_enc_{b}_{i + 1}', net, prec=prec)
        net = net + res_b
    net = res_block_train(p, 'encoder.res_block_enc_final', net, act=False, prec=prec) + res0
    net = slim_train(p, 'encoder.to_bn', net, stride=2, act=False, prec=prec)
    c = net.shape[1] - 1
    heat = torch.sigmoid(net[:, :1]) * c
    mask = torch.clamp(heat - torch.arange(c, dtype=net.dtype, device=net.device)[None, :, None, None],
                       0.0, 1.0)
    z = mask * net[:, 1:]
    centers = p['encoder.centers']
    dist = torch.square(z[..., None] - centers)
    qsoft = (torch.softmax(-dist, -1) * centers).sum(-1)
    symbols = torch.argmin(dist, -1)
    qhard = centers[symbols]
    qbar = qsoft + (qhard - qsoft).detach()
    net = slim_train(p, 'decoder.from_bn', qbar, stride=2, transpose=True, prec=prec)
    res0 = net
    for b in range(blocks):
        res_b = net
        for i in range(3):
            net = res_block_train(p, f'decoder.res_block_dec_{b}_{i + 1}', net, prec=prec)
        net = net + res_b
    net = res_block_train(p, 'decoder.dec_after_res', net, act=False, prec=prec) + res0
    net = slim_train(p, 'decoder.h12', net, stride=2, transpose=True, prec=prec)
    net = slim_train(p, 'decoder.h13', net, stride=2, act=False, transpose=True, prec=prec)
    x_out = torch.clamp(net.permute(0, 2, 3, 1) * std + mean, 0.0, 255.0)
    return qbar, symbols, mask, x_out


MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gauss_1d(size: int, sigma: float, device) -> torch.Tensor:
    n = size // 2
    x = np.arange(-n, n + 1, 1.0)
    g = np.exp(-x * x / (2 * sigma * sigma))
    return torch.from_numpy((g / np.sum(np.abs(g))).astype(np.float32)).to(device)


def _depthwise(x, k2d):
    c = x.shape[1]
    return F.conv2d(x, k2d.expand(c, 1, *k2d.shape), groups=c)


def ms_ssim_train(x_nhwc, y_nhwc, max_val=255.0):
    """Multi-scale SSIM of the training loss (Wang et al. 2003, as the
    published training code computes it): five scales, a separable VALID
    gaussian of min(11, H, W) taps (sigma = 1.5 size / 11; reflect-padded
    when the window is wider than the image), means over the batch, a 2-tap
    average with reflect padding (0, 1) and stride 2 between scales, cs and
    ssim clamped at 1e-6 before the powers."""
    a, b = x_nhwc.float().permute(0, 3, 1, 2), y_nhwc.float().permute(0, 3, 1, 2)
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mssim, mcs = [], []
    for level in range(5):
        size = min(11, a.shape[2], a.shape[3])
        k = _gauss_1d(size, size * 1.5 / 11, a.device)
        pad = max(k.shape[0] - a.shape[3], 0)

        def blur(t):
            if pad:
                t = F.pad(t, (pad, pad // 2, pad, pad // 2), mode='reflect')
            return _depthwise(_depthwise(t, k[None, :]), k[:, None])
        mu1, mu2 = blur(a), blur(b)
        s11 = blur(a * a) - mu1 * mu1
        s22 = blur(b * b) - mu2 * mu2
        s12 = blur(a * b) - mu1 * mu2
        v1, v2 = 2.0 * s12 + c2, s11 + s22 + c2
        mssim.append((((2.0 * mu1 * mu2 + c1) * v1) / ((mu1 * mu1 + mu2 * mu2 + c1) * v2)).mean())
        mcs.append((v1 / v2).mean())
        if level < 4:
            h = torch.full((2,), 0.5, device=a.device)

            def down(t):
                t = F.pad(t, (0, 1, 0, 1), mode='reflect')
                return _depthwise(_depthwise(t, h[None, :]), h[:, None])[:, :, ::2, ::2]
            a, b = down(a), down(b)
    w = torch.tensor(MSSSIM_WEIGHTS, device=a.device)
    mcs_t = torch.clamp(torch.stack(mcs), min=1e-6)
    mssim_t = torch.clamp(torch.stack(mssim), min=1e-6)
    return torch.prod(mcs_t[:4] ** w[:4]) * mssim_t[4] ** w[4]


def train_loss(ae_p: Dict, pc_p: Dict, x_nhwc, hp: Dict, prec='f32'):
    """The rate-distortion loss of one training batch: K_ms_ssim (1 -
    MS-SSIM) + beta max(H_soft - H_target, 0) with H_soft the mean of the
    bit cost and of the bit cost under the importance mask (the context
    model sees qbar with its gradient stopped, padded with centers[0]), +
    l2 on the AE's kernels and on the centers."""
    qbar, symbols, mask, x_out = ae_train(ae_p, x_nhwc, hp['arch_param_B'], prec)
    centers = ae_p['encoder.centers']
    pad = centers[0] if hp['use_centers_for_padding'] else 0.0
    logits = cm_logits(pc_p, qbar.detach(), pad, hp['kernel_size'], prec)
    nll = -torch.gather(torch.log_softmax(logits, 1), 1, symbols[:, None])[:, 0]
    bc = nll * math.log2(math.e)
    h_soft = 0.5 * ((bc * mask).mean() + bc.mean())
    rate = hp['beta'] * torch.clamp(h_soft - hp['H_target'], min=0.0)
    dist = hp['K_ms_ssim'] * (1.0 - ms_ssim_train(x_nhwc, x_out))
    reg = hp['regularization_factor'] * sum(0.5 * torch.sum(v * v) for k, v in ae_p.items()
                                            if k.endswith('.w'))
    reg_c = hp['regularization_factor_centers'] * 0.5 * torch.sum(centers * centers)
    return dist + rate + reg + reg_c


class Adam:
    """Adam (Kingma and Ba) with bias correction, betas (0.9, 0.999), eps
    1e-8 added to the corrected root, one learning rate a group."""

    def __init__(self, lrs: Dict[str, float], b1=0.9, b2=0.999, eps=1e-8):
        self.lrs, self.b1, self.b2, self.eps = lrs, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             group_of) -> None:
        self.t += 1
        for k, g in grads.items():
            m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
            mh, vh = m / (1 - self.b1 ** self.t), v / (1 - self.b2 ** self.t)
            params[k] = (params[k] - self.lrs[group_of(k)] * mh / (torch.sqrt(vh) + self.eps)).detach()
