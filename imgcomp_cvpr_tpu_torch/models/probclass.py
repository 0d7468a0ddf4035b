"""Masked-3D-conv autoregressive context model (port of
imgcomp_cvpr_tpu/models/probclass.py, ref probclass.py:199-221).

conv0 (first mask) -> residual block of two masked convs -> conv_out to L
logits, every conv VALID and ReLU'd except the block's second conv (the
reference leaves ReLU on its output layer, probclass.py:148-150). Only the
last depth slice of each (kd, k, k) kernel is causally masked. The
PyTorch version runs F.conv3d on NCDHW volumes; weights are stored in
conv3d's (cout, cin, kd, k, k) layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

LOG2_E = float(np.log2(np.e))


def num_layers() -> int:
    return 4


def context_size(config) -> int:
    return num_layers() * (config.kernel_size - 1) + 1


def context_shape(config) -> Tuple[int, int, int]:
    cs = context_size(config)
    return (cs // 2 + 1, cs, cs)


def filter_depth(kernel_size: int) -> int:
    return kernel_size // 2 + 1


def spatial_mask(kernel_size: int, first: bool) -> np.ndarray:
    """(K, K) mask for the last depth slice of the kernel."""
    k = kernel_size
    m = np.ones((k, k), np.float32)
    c = k // 2
    if first:
        m[c, c:] = 0.0
    else:
        m[c, c + 1:] = 0.0
    m[c + 1:, :] = 0.0
    return m


class MaskedConv3D(nn.Module):
    """Causal 3D conv, VALID: (N, cin, D, H, W) -> (N, cout, D-kd+1, H-K+1,
    W-K+1); output depth i corresponds to input depth i+kd-1."""

    def __init__(self, cin: int, features: int, kernel_size: int, first: bool,
                 act: bool = True):
        super().__init__()
        kd = filter_depth(kernel_size)
        self.act = act
        self.weight = nn.Parameter(torch.zeros(features, cin, kd, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        mask = np.ones((kd, kernel_size, kernel_size), np.float32)
        mask[-1] = spatial_mask(kernel_size, first)
        self.register_buffer('mask', torch.from_numpy(mask), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x, self.weight * self.mask, self.bias)
        return torch.relu(y) if self.act else y


class ResShallow(nn.Module):
    def __init__(self, config, num_centers: int):
        super().__init__()
        k, f = config.kernel_size, config.arch_param__k
        self.kernel_size = k
        self.conv0 = MaskedConv3D(1, f, k, first=True)
        self.res1 = nn.Module()
        self.res1.conv1 = MaskedConv3D(f, f, k, first=False, act=True)
        self.res1.conv2 = MaskedConv3D(f, f, k, first=False, act=False)
        self.conv_out = MaskedConv3D(f, num_centers, k, first=False, act=True)
        if getattr(config, 'learn_pad_var', False):
            # Learned pad value; auto_pad_value hands it to pad_volume,
            # whose (v - pv) + pv form carries the gradient back into it.
            self.pad_var = nn.Parameter(torch.zeros(()))

    def forward(self, volume: torch.Tensor, return_activations: bool = False):
        """(N, D, H, W) padded volume -> (N, L, D', H', W') logits (NCDHW);
        with return_activations a dict of every layer's output."""
        k = self.kernel_size
        dd, ds = 2 * (filter_depth(k) - 1), k - 1
        l1 = self.conv0(volume[:, None])
        l2 = self.res1.conv1(l1)
        l3 = self.res1.conv2(l2) + l1[:, :, dd:, ds:-ds, ds:-ds]
        logits = self.conv_out(l3)
        if return_activations:
            return {'l1': l1, 'l2': l2, 'l3': l3, 'logits': logits}
        return logits


def pad_volume(volume_dhw: torch.Tensor, cs: int, pad_value) -> torch.Tensor:
    """Pad (N, D, H, W): depth gets cs//2 in front only, H/W cs//2 on both
    sides (ref probclass.py:268-292). ``pad_value`` is a number or a 0-d
    tensor; zero-padding (v - pv) and adding pv back pads with pv and lets
    the gradient flow into a pv that requires it (centers[0] or the learned
    pad variable)."""
    pad = cs // 2
    pv = torch.as_tensor(pad_value, dtype=volume_dhw.dtype, device=volume_dhw.device)
    return F.pad(volume_dhw - pv, (pad, pad, pad, pad, pad, 0)) + pv


class ProbClassifier(nn.Module):
    """The context model with the padding/bitcost conventions
    (ref API: probclass.py:63-106). Its parameters live on ``device``
    (raises for 'cuda' with no card)."""

    def __init__(self, pc_config, num_centers: int, device='cuda'):
        super().__init__()
        if pc_config.arch != 'res_shallow':
            raise ValueError(f'unknown pc arch {pc_config.arch!r}')
        self.config = pc_config
        self.num_centers = num_centers
        self.net = ResShallow(pc_config, num_centers)
        self.context_size = context_size(pc_config)
        self.to(resolve_device(device))

    def logits(self, q_nhwc: torch.Tensor, pad_value) -> torch.Tensor:
        """(N, H, W, C) latent -> (N, D=C, H, W, L) logits for every symbol."""
        vol = q_nhwc.permute(0, 3, 1, 2)
        padded = pad_volume(vol, self.context_size, pad_value)
        logits = self.net(padded).permute(0, 2, 3, 4, 1)
        if logits.shape[1:4] != vol.shape[1:4]:
            raise AssertionError((logits.shape, vol.shape))
        return logits

    def bitcost(self, q_nhwc: torch.Tensor, symbols_nhwc: torch.Tensor,
                pad_value) -> torch.Tensor:
        """Per-symbol cross entropy in bits, NHWC like its inputs."""
        logits = self.logits(q_nhwc, pad_value)
        targets = symbols_nhwc.permute(0, 3, 1, 2).long()
        log_probs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(log_probs, -1, targets[..., None])[..., 0]
        return (nll * LOG2_E).permute(0, 2, 3, 1)


def init_params(pc: ProbClassifier, seed: int) -> ProbClassifier:
    """Fresh weights for ``pc`` in place, from an explicit torch.Generator
    seeded with ``seed``: the JAX initializer's distributions (glorot
    uniform over (kd, K, K, cin, cout), fan_in = cin kd K K and fan_out =
    cout kd K K; zero biases). The numbers differ from jax.random's."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (pc.net.conv0, pc.net.res1.conv1, pc.net.res1.conv2,
                     pc.net.conv_out):
            cout, cin = conv.weight.shape[:2]
            rf = int(np.prod(conv.weight.shape[2:]))
            limit = float(np.sqrt(6.0 / (cin * rf + cout * rf)))
            w = (torch.rand(conv.weight.shape, generator=g) * 2 - 1) * limit
            conv.weight.copy_(w.to(conv.weight.device))
            conv.bias.zero_()
    return pc


def auto_pad_value(pc_config, centers: torch.Tensor,
                   pc: Optional[ProbClassifier] = None) -> torch.Tensor:
    """0-d pad value of the context model's causal padding: the learned pad
    variable of ``pc`` when learn_pad_var is set, else centers[0] when
    use_centers_for_padding, else 0 (ref probclass.py:59-61). The tensor
    keeps its autograd history; a caller that needs a number takes float()."""
    if getattr(pc_config, 'learn_pad_var', False):
        if pc is None:
            raise ValueError('learn_pad_var=True requires pc to resolve the '
                             'learned pad variable')
        return pc.net.pad_var
    return centers[0] if pc_config.use_centers_for_padding else centers.new_zeros(())
