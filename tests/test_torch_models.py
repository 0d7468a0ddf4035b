"""Port vs JAX package: autoencoder with the trained weights, context model
logits / bitcost, and the weight mapping (CPU); the eval-mode conv epilogue
on the CPU against the eager towers it replaced."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ae_eager
from imgcomp_cvpr_tpu.models import autoencoder as jae
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.ops.kernels import ae_epilogue, build
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'assets', 'demo_trained_low_9000.npz')


@pytest.fixture(scope='module')
def trained():
    tree = tweights.load_npz(ASSET)
    ae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    ae = tae.CVPRAutoencoder(ae_cfg, device='cpu')
    pc = tpc.ProbClassifier(pc_cfg, ae_cfg.num_centers, device='cpu')
    ae, pc = tweights.load_trained(ASSET, ae, pc, device='cpu')
    return tree, ae, pc


def test_model_entry_points_raise_without_card(trained):
    """With no card the default device='cuda' raises instead of building,
    loading or running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    _, ae, pc = trained
    ae_cfg, pc_cfg = ae.config, pc.config
    with pytest.raises(RuntimeError, match='cuda'):
        tae.CVPRAutoencoder(ae_cfg)
    with pytest.raises(RuntimeError, match='cuda'):
        tpc.ProbClassifier(pc_cfg, ae_cfg.num_centers)
    with pytest.raises(RuntimeError, match='cuda'):
        tweights.load_trained(ASSET, ae, pc)
    assert next(ae.parameters()).device.type == 'cpu'


def _images(b=2, h=64, w=96, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.rand(b, h // 8, w // 8, 3)
    img = np.kron(base, np.ones((1, 8, 8, 1))) * 200 + rng.rand(b, h, w, 3) * 55
    return img.astype(np.float32)


def test_weights_every_npz_key_consumed_once(trained):
    tree, ae, pc = trained
    with np.load(ASSET) as z:
        n_keys = len(z.files)
    ae_sd = tweights.ae_state_dict(tree['params']['ae'], tree['batch_stats'], ae)
    pc_sd = tweights.pc_state_dict(tree['params']['pc'])
    assert len(ae_sd) + len(pc_sd) == n_keys
    assert set(ae_sd) == set(ae.state_dict())
    assert set(pc_sd) == set(pc.state_dict())


def test_ae_encode_decode_matches_jax(trained):
    tree, ae, _ = trained
    cfg, _ = jconfig.parse_spec('cvpr/low', 'ae')
    jmodel = jae.CVPRAutoencoder(cfg)
    jvars = {'params': tree['params']['ae'], 'batch_stats': tree['batch_stats']}
    x = _images()
    with jax.default_matmul_precision('highest'):
        jenc = jmodel.apply(jvars, jnp.asarray(x), False, method='encode')
        jdec = jmodel.apply(jvars, jenc.qhard, False, method='decode')
    tenc = ae.encode(torch.from_numpy(x))
    # z: f32 towers in two libraries, ~1e-6 relative per conv over 17 convs.
    np.testing.assert_allclose(tenc.z.numpy(), np.asarray(jenc.z), rtol=0, atol=1e-4)
    sym_t, sym_j = tenc.symbols.numpy(), np.asarray(jenc.symbols)
    mismatches = int((sym_t != sym_j).sum())
    assert mismatches <= 1e-3 * sym_j.size, mismatches
    # Decode identical symbols: the 0-255 image scale, 1e-2 absolute.
    tdec = ae.decode(torch.from_numpy(np.asarray(jenc.qhard)))
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=0, atol=1e-2)


def test_ae_bf16_towers_match_jax_bf16(trained):
    """bf16 towers (parameters f32, loaded by the unchanged load_trained)
    against the JAX package's CVPRAutoencoder(dtype=bfloat16) on the same
    images. Measured on the CPU (oneDNN against XLA, which round a bf16
    conv's f32 sum at different points): 9 of 6144 symbols differ from the
    JAX bf16 ones (bound 1%); 99.87% equal the port's f32 symbols (bound
    99%; the reference measured 99.89% on the TPU); decode of the same qhard
    within 1.084 of the JAX bf16 decode on the 0-255 scale (max; bound
    1.25), 0.089 on average (bound 0.15)."""
    tree, ae32, _ = trained
    cfg32 = ae32.config
    ae16 = tae.CVPRAutoencoder(cfg32, device='cpu', dtype=torch.bfloat16)
    pc = tpc.ProbClassifier(tconfig.parse_spec('cvpr/res_shallow', 'pc')[0],
                            cfg32.num_centers, device='cpu')
    ae16, _ = tweights.load_trained(ASSET, ae16, pc, device='cpu')
    sd32 = ae32.state_dict()
    for k, v in ae16.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, sd32[k]), k
    cfg, _ = jconfig.parse_spec('cvpr/low', 'ae')
    jmodel = jae.CVPRAutoencoder(cfg, dtype=jnp.bfloat16)
    jvars = {'params': tree['params']['ae'], 'batch_stats': tree['batch_stats']}
    x = _images()
    jenc = jax.jit(lambda v, x: jmodel.apply(v, x, False, method='encode'))(jvars, x)
    jdec = jax.jit(lambda v, q: jmodel.apply(v, q, False, method='decode'))(jvars, jenc.qhard)
    t16 = ae16.encode(torch.from_numpy(x))
    assert t16.z.dtype == torch.float32 and t16.qhard.dtype == torch.float32
    sym16, sym_j = t16.symbols.numpy(), np.asarray(jenc.symbols)
    assert int((sym16 != sym_j).sum()) <= 0.01 * sym_j.size
    agree = float((sym16 == ae32.encode(torch.from_numpy(x)).symbols.numpy()).mean())
    assert agree >= 0.99, agree
    tdec = ae16.decode(torch.from_numpy(np.array(jenc.qhard)))
    assert tdec.dtype == torch.float32
    diff = np.abs(tdec.numpy() - np.asarray(jdec))
    assert diff.max() <= 1.25 and diff.mean() <= 0.15, (diff.max(), diff.mean())
    with pytest.raises(ValueError, match='float32'):
        ae16(torch.from_numpy(x), True)


def _pc_pair(kf=8, L=6, seed=0, shape_nhwc=(2, 5, 6, 4)):
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=kf)
    jm = jpc.ProbClassifier(cfg, L)
    params = jm.init(jax.random.PRNGKey(seed), shape_nhwc)
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tm = tpc.ProbClassifier(tcfg.replace(arch_param__k=kf), L, device='cpu')
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm.load_state_dict(tweights.pc_state_dict(np_params), strict=True)
    return jm, params, tm


def test_pc_logits_and_bitcost_match_jax():
    jm, params, tm = _pc_pair()
    rng = np.random.RandomState(4)
    centers = np.linspace(-2, 2, 6).astype(np.float32)
    syms = rng.randint(0, 6, (2, 5, 6, 4))
    q = centers[syms]
    with jax.default_matmul_precision('highest'):
        jl = jm.logits(params, jnp.asarray(q), centers[0])
        jb = jm.bitcost(params, jnp.asarray(q), jnp.asarray(syms), centers[0])
    tl = tm.logits(torch.from_numpy(q), float(centers[0]))
    tb = tm.bitcost(torch.from_numpy(q), torch.from_numpy(syms), float(centers[0]))
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    assert tpc.context_size(tm.config) == jpc.context_size(tm.config) == 9


def test_heatmap_and_normalize_match_jax():
    rng = np.random.RandomState(5)
    b = rng.randn(2, 3, 4, 9).astype(np.float32)
    np.testing.assert_allclose(tae.get_heatmap3d(torch.from_numpy(b)).numpy(),
                               np.asarray(jae.get_heatmap3d(jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    x = (rng.rand(2, 4, 4, 3) * 255).astype(np.float32)
    np.testing.assert_allclose(tae.normalize(torch.from_numpy(x), 'FIXED').numpy(),
                               np.asarray(jae.normalize(jnp.asarray(x), 'FIXED')),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The eval-mode epilogue on the CPU, against the eager towers (ae_eager.py)
# ---------------------------------------------------------------------------

def _reloaded(ae, sd):
    fresh = tae.CVPRAutoencoder(ae.config, device='cpu', dtype=ae.encoder.h1.dtype)
    fresh.load_state_dict(sd, strict=True)
    return fresh


@pytest.mark.parametrize('case', ['eval_f32_unchanged', 'eval_bf16_unchanged',
                                  'train_bypasses_epilogue', 'refold_after_load_state_dict',
                                  'refold_after_bn_update', 'launch_counter'])
def test_ae_eval_epilogue_on_cpu(trained, monkeypatch, case):
    """Eval on the CPU runs the plain chain (the towers' outputs equal the
    eager towers' bit for bit, 35 epilogues an encode and 35 a decode, no
    kernel launch); train mode never reaches the epilogue and computes what
    the eager towers do; the folded operands follow load_state_dict and an
    in-place running-statistics update."""
    _, ae32, _ = trained
    x = torch.from_numpy(_images())
    calls = []
    real = ae_epilogue.epilogue

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ae_epilogue, 'epilogue', spy)
    before = build.LAUNCHES['ae_epilogue']
    if case in ('eval_f32_unchanged', 'eval_bf16_unchanged'):
        ae = ae32
        if case == 'eval_bf16_unchanged':
            ae = tae.CVPRAutoencoder(ae32.config, device='cpu', dtype=torch.bfloat16)
            ae.load_state_dict(ae32.state_dict(), strict=True)
        enc = ae.encode(x)
        assert len(calls) == 35
        with torch.no_grad():
            assert torch.equal(enc.z, ae_eager.encode_z(ae.encoder, x, False))
            assert torch.equal(ae.decode(enc.qhard), ae_eager.decode(ae.decoder, enc.qhard, False))
        assert len(calls) == 70
    elif case == 'train_bypasses_epilogue':
        ae, eager = copy.deepcopy(ae32), copy.deepcopy(ae32)
        monkeypatch.setattr(ae_epilogue, 'epilogue', None)   # a call would raise
        enc, x_out = ae(x, True)
        assert torch.equal(enc.z, ae_eager.encode_z(eager.encoder, x, True))
        assert torch.equal(x_out, ae_eager.decode(eager.decoder, enc.qbar, True))
        for (k, a), b in zip(ae.state_dict().items(), eager.state_dict().values()):
            assert torch.equal(a, b), k
    elif case == 'refold_after_load_state_dict':
        ae = copy.deepcopy(ae32)
        z0 = ae.encode(x).z
        sd = {k: v * 1.01 if k.endswith(('bn_mean', 'bn_bias', 'weight')) else v
              for k, v in ae.state_dict().items()}
        ae.load_state_dict(sd, strict=True)
        z1 = ae.encode(x).z
        assert not torch.equal(z0, z1)
        assert torch.equal(z1, _reloaded(ae, sd).encode(x).z)
    elif case == 'refold_after_bn_update':
        ae = copy.deepcopy(ae32)
        z0 = ae.encode(x).z
        with torch.no_grad():
            ae(x * 0.5, True)        # moves every running mean and variance in place
        z1 = ae.encode(x).z
        assert not torch.equal(z0, z1)
        assert torch.equal(z1, _reloaded(ae, ae.state_dict()).encode(x).z)
    else:
        assert 'ae_epilogue' in build.SOURCES and 'ae_epilogue' in build.LAUNCHES
        ae32.decode(ae32.encode(x).qhard)
        assert len(calls) == 70
    assert build.LAUNCHES['ae_epilogue'] == before
