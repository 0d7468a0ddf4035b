"""The planar codec's bias rows (coding/bias_rows.py) on the CPU: the plain
versions against the JAX package's conv_lower + bias, the encode layout
against the decode layout, and the calls a round trip counts.

The JAX side is conv_lower as imgcomp_cvpr_tpu/coding/planar_codec.py:260-270
writes it (one VALID NHWC convolution a plane below, summed oldest first),
under jax.jit, with the JAX model's own lower kernel slices; the port's
model gets the same weights through weights.pc_state_dict.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import bias_rows as br
from imgcomp_cvpr_tpu_torch.coding import planar as tplanar
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.ops.kernels import build
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

L = 6
SHAPE = (3, 12, 20)
CENTERS = torch.linspace(-2, 2, L)
LAYERS = (('conv0',), ('res1', 'conv1'), ('res1', 'conv2'), ('conv_out',))
# (K, kf): the shipped widths (the kernel's compile-time instance on the card)
# and a generic one.
WIDTHS = [(5, 24), (7, 8)]


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _models(K, kf, seed=0):
    """The JAX model's parameters (random biases: they are 0 at init) and
    the port's model with the same weights, and its planar fold."""
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(kernel_size=K, arch_param__k=kf)
    params = jax.tree_util.tree_map(np.asarray, jpc.ProbClassifier(cfg, L).init(
        jax.random.PRNGKey(seed), (1, SHAPE[1], SHAPE[2], SHAPE[0])))
    rng = np.random.RandomState(seed)
    for name in LAYERS:
        node = params['params']
        for part in name:
            node = node[part]
        node['b'] = (rng.randn(*node['b'].shape) * 0.1).astype(np.float32)
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tm = tpc.ProbClassifier(tcfg.replace(kernel_size=K, arch_param__k=kf), L, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(params))
    return params['params'], tpcodec.fold_planar(tm, CENTERS)


def _layer(params, level):
    node = params
    for part in LAYERS[level - 1]:
        node = node[part]
    return node['w'], node['b']


@jax.jit
def _conv_lower(planes, w_low):
    """planar_codec.py:260-270: planes (kd-1, b, Hg, Wg, cin), oldest first;
    w_low (kd-1, K, K, cin, cout) -> (b, Hg-K+1, Wg-K+1, cout)."""
    out = None
    for j in range(planes.shape[0]):
        y = jax.lax.conv_general_dilated(planes[j], w_low[j], (1, 1), 'VALID',
                                         dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
        out = y if out is None else out + y
    return out


def _volume(fold, K, b, seed):
    """Random activations of every level 0..3 of b images x C planes, as
    the kernels leave them: level 0 (b*C, H0, W0), levels 1-3 (b*C, H, W,
    kf)."""
    rng = np.random.RandomState(seed)
    grids = tplanar.grids_2d(SHAPE[1:], K)
    kf = fold.consts[0].shape[0]
    return [torch.from_numpy(rng.randn(b * SHAPE[0], *g, *(() if l == 0 else (kf,)))
                             .astype(np.float32)) for l, g in enumerate(grids[:4])]


def _below(fold, level, vol, b, d, kd):
    """The kd-1 planes below plane d of level ``level - 1`` for JAX:
    (kd-1, b, H, W, cin), the all-pad constants below plane 0."""
    C = SHAPE[0]
    x = vol[level - 1].reshape(b, C, *vol[level - 1].shape[1:3], -1)
    const = br._const(fold, level)
    return np.stack([np.broadcast_to(const.numpy(), x[:, 0].shape) if p < 0 else x[:, p].numpy()
                     for p in range(d - kd + 1, d)])


def _decode_layout(fold, K, vol, b):
    """plane_rows_plain plane by plane over the volume: (b, C, H, W, cout)
    per level."""
    C = SHAPE[0]
    kd = K // 2 + 1
    hist = br.history(b, tplanar.grids_2d(SHAPE[1:], K), kd)
    rows = [[] for _ in range(4)]
    for d in range(C):
        for l, r in enumerate(br.plane_rows_plain(fold, hist)):
            rows[l].append(r)
        planes = [v.reshape(b, C, *v.shape[1:])[:, d] for v in vol]
        br.push(hist, planes[0], planes[1:])
    return [torch.stack(r, 1) for r in rows]


@pytest.mark.parametrize('K,kf', WIDTHS)
def test_plain_bias_rows_match_jax_conv_lower(K, kf):
    """Both layouts of the plain bias rows, on random activations of every
    level with the all-pad constants below plane 0, against the JAX
    package's conv_lower + bias. Tolerance 1e-5 absolute (the rows are
    O(1)): each output sums 2 x K x K x cin float32 products (1200 at K=5,
    kf=24), oneDNN and XLA in different orders, a few ulp of the partial
    sums apart."""
    params, fold = _models(K, kf, seed=1)
    b, C, kd = 2, SHAPE[0], K // 2 + 1
    vol = _volume(fold, K, b, seed=2)
    dec = _decode_layout(fold, K, vol, b)
    for level in range(1, 5):
        enc = br.level_rows_plain(fold, level, vol[level - 1], C)
        w, bias = _layer(params, level)
        for d in range(C):
            ref = np.asarray(_conv_lower(_below(fold, level, vol, b, d, kd), w[:kd - 1])) + bias
            got = enc.reshape(b, C, *enc.shape[1:])[:, d].numpy()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
            np.testing.assert_allclose(dec[level - 1][:, d].numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('K,kf', WIDTHS)
def test_encode_layout_equals_decode_layout(K, kf):
    """The encode layout (a level of all planes a call) gives the decode
    layout's rows (all levels of one plane a call) bit for bit, and an
    image's rows do not depend on the batch: each (image, plane) is one
    F.conv2d on the same contiguous input either way."""
    _, fold = _models(K, kf, seed=3)
    b, C = 3, SHAPE[0]
    vol = _volume(fold, K, b, seed=4)
    dec = _decode_layout(fold, K, vol, b)
    one = _decode_layout(fold, K, [v[C:2 * C] for v in vol], 1)
    for level in range(1, 5):
        enc = br.level_rows_plain(fold, level, vol[level - 1], C)
        assert torch.equal(enc.reshape(b, C, *enc.shape[1:]), dec[level - 1])
        assert torch.equal(one[level - 1][0], dec[level - 1][1])


@pytest.mark.parametrize('C', [1, 3])
def test_bias_rows_calls_a_round_trip(C):
    """A planar round trip of C planes makes 4 + C bias-row calls: one a
    level in encode, one a plane in decode. On the CPU they run the plain
    versions, which launch nothing: the kernel's counter stays put."""
    cfg, _ = tconfig.parse_spec('base', 'pc')
    cfg = cfg.replace(arch_param__k=8)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), 5)
    coder = tpcodec.PlanarCoder(pc, cfg, device='cpu')
    syms = torch.from_numpy(np.random.RandomState(5).randint(0, L, (2, C, 6, 7)))
    before = build.LAUNCHES['bias_rows']
    with mock.patch.object(br, 'level_rows', wraps=br.level_rows) as lv, \
            mock.patch.object(br, 'plane_rows', wraps=br.plane_rows) as pl:
        res = coder.encode_batch(syms, CENTERS)
        assert (lv.call_count, pl.call_count) == (4, 0)
        dec = coder.decode_batch([r.bitstream for r in res], CENTERS)
        assert (lv.call_count, pl.call_count) == (4, C)
    assert build.LAUNCHES['bias_rows'] == before
    assert torch.equal(dec.long(), syms)
