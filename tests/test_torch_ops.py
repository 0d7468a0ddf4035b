"""Port vs JAX package: quantizer and TF-'SAME' convolutions (CPU); and
the binding of the kernels' C entries (build.entry) on a stand-in library.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU, its Pallas quantizer in interpret mode.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.ops import tf_compat as jtf
from imgcomp_cvpr_tpu.ops.pallas import quantize as jpq
from imgcomp_cvpr_tpu_torch.models import quantizer as tquant
from imgcomp_cvpr_tpu_torch.ops import tf_compat as ttf
from imgcomp_cvpr_tpu_torch.ops.kernels import build
from imgcomp_cvpr_tpu_torch.ops.kernels import quantize as tqk


@pytest.mark.parametrize('shape', [(2, 16, 16, 8), (3, 7, 5, 3)])
def test_quantizer_plain_matches_pallas(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 2
    c = np.sort(rng.uniform(-2, 2, 6)).astype(np.float32)
    ref = jpq.quantize_pallas(jnp.asarray(x), jnp.asarray(c), 1.0)
    out = tquant.quantize(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_array_equal(out.symbols.numpy(), np.asarray(ref.symbols))
    # Tolerance: f32 exp/divide in a different library, a few ulp of [-2, 2].
    np.testing.assert_allclose(out.qsoft.numpy(), np.asarray(ref.qsoft), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.qhard.numpy(), np.asarray(ref.qhard), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.qbar.numpy(), np.asarray(ref.qbar), rtol=0, atol=1e-6)


def test_quantize_wrapper_cpu_uses_plain():
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    c = torch.linspace(-2, 2, 6)
    a = tqk.quantize_fwd(x, c)
    b = tqk.quantize_plain(x, c)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(TypeError):
        tqk.quantize_fwd(x.double(), c)


@pytest.fixture
def stand_in_library(monkeypatch):
    """build.load handing out the process's own C library (libc) in place of
    a kernel library, counting its calls, with no entry bound yet."""
    loads = []

    def load(name):
        loads.append(name)
        return ctypes.CDLL(None)

    monkeypatch.setattr(build, 'load', load)
    monkeypatch.setattr(build, '_entries', {})
    return loads


def test_build_entry_binds_a_symbol_once(stand_in_library):
    """build.entry binds a C entry on first use, with its argument types and
    an int return, and hands the same function out after that."""
    fn = build.entry('stand_in', 'abs', (ctypes.c_int,))
    assert fn.argtypes == (ctypes.c_int,) and fn.restype is ctypes.c_int
    assert fn(-7) == 7
    assert build.entry('stand_in', 'abs', [ctypes.c_int]) is fn
    assert stand_in_library == ['stand_in']
    build.entry('stand_in', 'labs', (ctypes.c_long,))
    assert stand_in_library == ['stand_in', 'stand_in']


def test_build_entry_refuses_other_argtypes(stand_in_library):
    """A symbol asked for again with other argument types raises, and keeps
    the types it was bound with."""
    fn = build.entry('stand_in', 'abs', (ctypes.c_int,))
    with pytest.raises(TypeError, match='stand_in.abs'):
        build.entry('stand_in', 'abs', (ctypes.c_longlong,))
    assert fn.argtypes == (ctypes.c_int,)
    assert stand_in_library == ['stand_in']


@pytest.mark.parametrize('size,k,s', [(7, 3, 1), (7, 5, 2), (8, 5, 2), (9, 3, 2),
                                      (13, 5, 2)])
def test_same_pad_amounts(size, k, s):
    assert ttf.same_pad_amounts(size, k, s) == jtf.same_pad_amounts(size, k, s)


@pytest.mark.parametrize('hw,k,s', [((7, 9), 3, 1), ((7, 9), 5, 2), ((8, 6), 5, 2),
                                    ((9, 11), 3, 2)])
def test_conv2d_same_matches_jax(hw, k, s):
    rng = np.random.RandomState(1)
    x = rng.randn(2, hw[0], hw[1], 4).astype(np.float32)
    w = rng.randn(k, k, 4, 5).astype(np.float32) * 0.3
    ref = jtf.conv2d_same(jnp.asarray(x), jnp.asarray(w), s,
                          precision=jax.lax.Precision.HIGHEST)
    out = ttf.conv2d_same(torch.from_numpy(x), torch.from_numpy(w), s)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize('hw,k,s', [((4, 6), 3, 2), ((5, 3), 5, 2), ((4, 4), 5, 2),
                                    ((3, 7), 3, 1)])
def test_conv2d_transpose_same_matches_jax(hw, k, s):
    rng = np.random.RandomState(2)
    x = rng.randn(2, hw[0], hw[1], 4).astype(np.float32)
    w = rng.randn(k, k, 4, 3).astype(np.float32) * 0.3
    ref = jtf.conv2d_transpose_same(jnp.asarray(x), jnp.asarray(w), s,
                                    precision=jax.lax.Precision.HIGHEST)
    out = ttf.conv2d_transpose_same(torch.from_numpy(x), torch.from_numpy(w), s)
    assert out.shape == ref.shape == (2, hw[0] * s, hw[1] * s, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_conv2d_valid_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 8, 3).astype(np.float32)
    w = rng.randn(3, 3, 3, 6).astype(np.float32) * 0.3
    ref = jtf.conv2d_valid(jnp.asarray(x), jnp.asarray(w),
                           precision=jax.lax.Precision.HIGHEST)
    out = ttf.conv2d_valid(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
