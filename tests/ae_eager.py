"""The autoencoder's towers as eager PyTorch, written as they were before
the fused eval-mode epilogue (models/autoencoder.py): each SlimConv a conv on
a padded NCHW copy, then BatchNorm, the cast, ReLU as separate ops, the
block's and the group's skips as separate adds. Tests hold the port's
towers to it: on the CPU bit for bit, on the card within the benchmark's
limits. Imports no JAX, so the card's tests use it too."""

import torch

from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.ops import tf_compat


def conv(m, x, train):
    dt = m.dtype
    op = tf_compat.conv2d_transpose_same_nchw if m.transpose else tf_compat.conv2d_same_nchw
    y = op(x.to(dt), m.weight.to(dt), m.stride).float()
    if train:
        mean = y.mean((0, 2, 3))
        var = torch.clamp(torch.square(y).mean((0, 2, 3)) - torch.square(mean), min=0.0)
        with torch.no_grad():
            m.bn_mean.mul_(m.BN_MOMENTUM).add_(mean, alpha=1 - m.BN_MOMENTUM)
            m.bn_var.mul_(m.BN_MOMENTUM).add_(var, alpha=1 - m.BN_MOMENTUM)
    else:
        mean, var = m.bn_mean, m.bn_var
    mul = torch.rsqrt(var + m.BN_EPS) * m.bn_scale
    y = ((y - mean[:, None, None]) * mul[:, None, None] + m.bn_bias[:, None, None]).to(dt)
    return torch.relu(y) if m.act else y


def block(blk, x, train):
    y = conv(blk.conv2, conv(blk.conv1, x, train), train)
    return y + x.to(y.dtype)


def _groups(mod, net, prefix, final, train):
    residual_input_0 = net
    for b in range(mod.config.arch_param_B):
        residual_input_b = net
        for i in range(3):
            net = block(getattr(mod, f'{prefix}_{b}_{i + 1}'), net, train)
        net = net + residual_input_b
    return block(final, net, train) + residual_input_0


def encode_z(enc, x_nhwc, train):
    """The bottleneck after the importance map, as EncoderOutput.z."""
    net = tae.normalize(x_nhwc, enc.config.normalization).permute(0, 3, 1, 2)
    net = conv(enc.h2, conv(enc.h1, net, train), train)
    net = _groups(enc, net, 'res_block_enc', enc.res_block_enc_final, train)
    net = conv(enc.to_bn, net, train).permute(0, 2, 3, 1).float()
    return tae.get_heatmap3d(net) * net[..., 1:]


def decode(dec, q_nhwc, train):
    net = conv(dec.from_bn, q_nhwc.permute(0, 3, 1, 2), train)
    net = _groups(dec, net, 'res_block_dec', dec.dec_after_res, train)
    net = conv(dec.h13, conv(dec.h12, net, train), train)
    net = net.permute(0, 2, 3, 1).float()
    return torch.clamp(tae.denormalize(net, dec.config.normalization), 0.0, 255.0)
