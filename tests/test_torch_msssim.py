"""Port vs JAX package: MS-SSIM (training and eval variants), value and
gradient, on the CPU.

Sizes: 32 and 160 reach the reflect-pad branch of the train variant (a
scale whose window min(11, H, W) is even builds one tap more than the image
is wide: 32 -> 8x8 at the third scale, 160 -> 10x10 at the fifth, the
full-width training crop); 176 is the smallest size whose five scales all
keep the 11-tap window, so it never pads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.ops import msssim as jms
from imgcomp_cvpr_tpu_torch.ops import msssim as tms
from imgcomp_cvpr_tpu_torch.ops import tf_compat as ttf
from imgcomp_cvpr_tpu.ops import tf_compat as jtf


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(size, seed=0, n=2):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, size // 4, size // 4, 3)
    x = (np.kron(base, np.ones((1, 4, 4, 1))) * 200 + rng.rand(n, size, size, 3) * 55)
    y = np.clip(x + rng.randn(n, size, size, 3) * 12, 0, 255)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize('variant,size', [('train', 32), ('train', 160), ('train', 176),
                                          ('eval', 32), ('eval', 176)])
def test_msssim_value_and_gradient_match_jax(variant, size):
    x, y = _pair(size, n=2 if size == 32 else 1)
    jfn = jms.msssim_train if variant == 'train' else jms.msssim_eval
    tfn = tms.msssim_train if variant == 'train' else tms.msssim_eval
    jv, jg = jax.value_and_grad(lambda b: jfn(jnp.asarray(x), b))(jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_()
    tv = tfn(torch.from_numpy(x), yt)
    tv.backward()
    assert 0.0 < float(tv.detach()) < 1.0
    # f32 blurs of products of 0..255 pixels (sigma = E[x^2] - mu^2 cancels
    # ~4 digits) under fractional powers, in two libraries.
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=2e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jg), rtol=0, atol=2e-4 * scale)


def test_msssim_pad_branch_is_where_the_docstring_says():
    for size, padded_levels in ((32, [2, 3, 4]), (160, [4]), (176, [])):
        hit, w = [], size
        for level in range(5):
            k = tms._gauss_kernel_1d(min(11, w) * 1.5 / 11, min(11, w))
            if k.shape[0] > w:
                hit.append(level)
            w = (w + 1) // 2
        assert hit == padded_levels, (size, hit)


def test_msssim_train_clamps_negative_scales():
    """Anti-correlated images drive cs below 0; the train variant clamps at
    1e-6 before the fractional powers, the eval variant returns NaN like the
    reference's."""
    x, _ = _pair(32)
    y = 255.0 - x
    tv = tms.msssim_train(torch.from_numpy(x), torch.from_numpy(y))
    jv = jms.msssim_train(jnp.asarray(x), jnp.asarray(y))
    assert np.isfinite(float(tv))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4)
    assert np.isnan(float(tms.msssim_eval(torch.from_numpy(x), torch.from_numpy(y))))
    assert np.isnan(float(jms.msssim_eval(jnp.asarray(x), jnp.asarray(y))))


def test_msssim_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tms.msssim_train(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 16, 3))


def test_depthwise_conv_and_reflect_pad_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 7, 3).astype(np.float32)
    pad = ((1, 0), (0, 2))
    np.testing.assert_array_equal(
        ttf.reflect_pad_hw_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), pad)
        .permute(0, 2, 3, 1).numpy(),
        np.asarray(jtf.reflect_pad_hw(jnp.asarray(x), pad)))
    # one kernel shared by every channel, the blurs' case
    k = rng.randn(2, 3).astype(np.float32)
    wk = np.broadcast_to(k[:, :, None, None], (2, 3, 3, 1))
    np.testing.assert_allclose(
        ttf.depthwise_conv2d_valid_nchw(torch.from_numpy(x).permute(0, 3, 1, 2),
                                        torch.from_numpy(k)).permute(0, 2, 3, 1).numpy(),
        np.asarray(jtf.depthwise_conv2d_valid(jnp.asarray(x), jnp.asarray(wk))),
        rtol=1e-5, atol=1e-6)
