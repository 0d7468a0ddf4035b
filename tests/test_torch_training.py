"""Port vs JAX package: the training slice on the CPU.

Kernel 7's plain version (the quantizer backward) against torch autograd,
the JAX Pallas backward in interpret mode and the XLA path; train-mode
BatchNorm against flax; distortions, losses, schedules and optimizer groups;
and the slice as a whole: with weights carried from the JAX trainer's
init_state, the port's loss, comps and every parameter gradient against
``jax.value_and_grad(Trainer._loss_fn)``, then a 5-step Adam trajectory.
Inputs come from numpy seeds; every tolerance is stated where it is used.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from imgcomp_cvpr_tpu.models import autoencoder as jae
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.models import quantizer as jquantizer
from imgcomp_cvpr_tpu.ops.pallas import quantize as jpq
from imgcomp_cvpr_tpu.training import distortions as jdist
from imgcomp_cvpr_tpu.training import losses as jlosses
from imgcomp_cvpr_tpu.training import optimizers as jopt
from imgcomp_cvpr_tpu.training import trainer as jtrainer
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.models import quantizer as tquantizer
from imgcomp_cvpr_tpu_torch.ops import metrics as tmetrics
from imgcomp_cvpr_tpu_torch.ops.kernels import quantize as qk
from imgcomp_cvpr_tpu_torch.training import distortions as tdist
from imgcomp_cvpr_tpu_torch.training import losses as tlosses
from imgcomp_cvpr_tpu_torch.training import optimizers as topt
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return tweights._flatten(tree)


def tiny_configs(mod, **ae_over):
    """The tiny configs of tests/test_training.py, from either package's parser."""
    ae, _ = mod.parse_spec('cvpr/low', 'ae')
    pc, _ = mod.parse_spec('cvpr/res_shallow', 'pc')
    over = dict(arch_param_B=1, num_chan_bn=4, batch_size=2, crop_size=(32, 32),
                distortion_to_minimize='mse')
    over.update(ae_over)
    return ae.replace(**over), pc.replace(arch_param__k=4)


@functools.lru_cache(maxsize=None)
def _jax_init_state_once():
    jt = jtrainer.Trainer(*tiny_configs(jconfig), num_train_images=64)
    return jax.jit(lambda key: jt.init_state(key, crop_hw=(32, 32), batch_size=2))(
        jax.random.PRNGKey(0))


def _jax_init_state():
    """A copy of the JAX trainer's initial state at the tiny configs (32x32,
    B=2, key 0), which is made once under jit: op by op it compiles every
    initializer on its own, and it depends on neither the distortion nor the
    quantizer's implementation. A copy, because train_step donates its state."""
    return jax.tree_util.tree_map(jnp.copy, _jax_init_state_once())


# ---------------------------------------------------------------------------
# Kernel 7's plain version
# ---------------------------------------------------------------------------

def _quant_setup(seed=0, shape=(4, 8, 8, 4)):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2
    centers = np.sort(rng.uniform(-2, 2, 6)).astype(np.float32)
    return x, centers


def _torch_quant_loss(out):
    """The loss of tests/test_pallas_quantize.py:40-70 with the qhard ->
    centers gather added: every output of the quantizer carries a cotangent."""
    return ((out.qbar * torch.cos(out.qbar)).sum() + (out.qsoft ** 2).sum()
            + (out.qhard ** 2).sum())


def _jax_quant_loss(out):
    return (jnp.sum(out.qbar * jnp.cos(out.qbar)) + jnp.sum(out.qsoft ** 2)
            + jnp.sum(out.qhard ** 2))


@pytest.mark.parametrize('shape', [(4, 8, 8, 4), (3, 7, 5, 3)])
def test_quantize_bwd_plain_matches_torch_autograd(shape):
    x_np, c_np = _quant_setup(shape=shape)
    x = torch.from_numpy(x_np).requires_grad_()
    c = torch.from_numpy(c_np).requires_grad_()
    _torch_quant_loss(tquantizer.quantize(x, c)).backward()     # QuantizeFn: the plain pair

    x2 = torch.from_numpy(x_np).requires_grad_()
    c2 = torch.from_numpy(c_np).requires_grad_()
    qsoft, qhard, _ = qk.quantize_plain(x2, c2)                 # autograd through the forward
    qbar = qsoft + (qhard - qsoft).detach()
    _torch_quant_loss(tquantizer.QuantizerOutput(qbar, qsoft, qhard, None)).backward()
    # Two f32 evaluations of the same derivative in different op orders.
    np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c.grad.numpy(), c2.grad.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('impl', ['pallas', 'xla'])
@pytest.mark.parametrize('shape', [(4, 8, 8, 4), (3, 7, 5, 3)])
def test_quantize_gradients_match_jax(impl, shape):
    """QuantizeFn (plain pair on the CPU) against jax.grad through the Pallas
    custom_vjp in interpret mode and through the XLA path; (3, 7, 5, 3) is
    not a multiple of the TPU kernel's (64, 128) tile."""
    x_np, c_np = _quant_setup(shape=shape)
    x = torch.from_numpy(x_np).requires_grad_()
    c = torch.from_numpy(c_np).requires_grad_()
    out = tquantizer.quantize(x, c)
    _torch_quant_loss(out).backward()

    def loss(xj, cj):
        if impl == 'pallas':
            return _jax_quant_loss(jpq.quantize_pallas(xj, cj, 1.0))
        return _jax_quant_loss(jquantizer.quantize(xj, cj, impl='xla'))

    gx, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x_np), jnp.asarray(c_np))
    # The tolerances tests/test_pallas_quantize.py holds Pallas to against XLA.
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), rtol=2e-4, atol=2e-4)


def test_quantize_bwd_plain_gradcheck_float64():
    """The plain forward / backward pair as one autograd function, in
    float64, against finite differences (x kept away from the argmin
    boundaries, where qhard jumps)."""

    class PlainPair(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, centers):
            ctx.save_for_backward(x, centers)
            qsoft, qhard, _ = qk.quantize_plain(x, centers)
            return qsoft, qhard

        @staticmethod
        def backward(ctx, g, gh):
            return qk.quantize_bwd_plain(*ctx.saved_tensors, g, gh)

    rng = np.random.RandomState(3)
    centers = torch.tensor([-1.7, -0.9, -0.2, 0.5, 1.1, 1.9], dtype=torch.float64)
    x = torch.from_numpy(rng.uniform(-2.5, 2.5, (3, 5, 4)))
    mids = (centers[1:] + centers[:-1]) / 2
    x = x[(x[..., None] - mids).abs().min(-1).values > 1e-2].clone()
    assert x.numel() > 40
    assert torch.autograd.gradcheck(PlainPair.apply, (x.requires_grad_(),
                                                      centers.requires_grad_()),
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_quantize_fn_absent_cotangents():
    """A loss that reads only qhard (or only qsoft) hands the backward None
    for the other cotangent; None counts as 0."""
    x_np, c_np = _quant_setup(shape=(2, 8, 8, 2))
    for pick in ('qhard', 'qsoft'):
        x = torch.from_numpy(x_np).requires_grad_()
        c = torch.from_numpy(c_np).requires_grad_()
        (getattr(tquantizer.quantize(x, c), pick) ** 2).sum().backward()
        gc = jax.grad(lambda cj: jnp.sum(getattr(
            jquantizer.quantize(jnp.asarray(x_np), cj, impl='xla'), pick) ** 2))(
                jnp.asarray(c_np))
        np.testing.assert_allclose(c.grad.numpy(), np.asarray(gc), rtol=1e-4, atol=1e-4)
        if pick == 'qhard':
            assert float(x.grad.abs().max()) == 0.0
    dx, dc = qk.quantize_bwd_plain(torch.from_numpy(x_np), torch.from_numpy(c_np),
                                   None, None)
    assert float(dx.abs().max()) == 0.0 and float(dc.abs().max()) == 0.0


def test_quantizer_init_and_regularization():
    g = torch.Generator().manual_seed(0)
    c = tquantizer.init_centers(g, 1000, (-2, 2))
    assert c.shape == (1000,) and c.dtype == torch.float32
    assert -2 <= float(c.min()) < -1.9 and 1.9 < float(c.max()) <= 2
    c_np = np.linspace(-2, 2, 6).astype(np.float32)
    np.testing.assert_allclose(
        float(tquantizer.centers_regularization(torch.from_numpy(c_np), 0.1)),
        float(jquantizer.centers_regularization(jnp.asarray(c_np), 0.1)), rtol=1e-6)
    assert float(tquantizer.centers_regularization(torch.from_numpy(c_np), None)) == 0.0


# ---------------------------------------------------------------------------
# Train-mode SlimConv vs flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('transpose', [False, True])
def test_slimconv_train_mode_matches_flax(transpose):
    """Output and the running statistics after one and two training steps
    (biased batch variance, ra = 0.9 ra + 0.1 batch), then the eval output
    with the moved statistics."""
    rng = np.random.RandomState(11)
    cin, cout, k, stride = 3, 5, 3, 2
    jm = jae.SlimConv(cout, k, stride=stride, act=True, transpose=transpose)
    x1 = rng.randn(4, 6, 7, cin).astype(np.float32)
    x2 = (rng.randn(4, 6, 7, cin) * 2 + 1).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x1), True)
    params = _np_tree(variables['params'])
    params['BatchNorm_0']['scale'] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    params['BatchNorm_0']['bias'] = rng.randn(cout).astype(np.float32)
    stats = variables['batch_stats']

    tm = tae.SlimConv(cin, cout, k, stride=stride, act=True, transpose=transpose)
    w = params['w'].transpose((2, 3, 0, 1) if transpose else (3, 2, 0, 1))
    tm.load_state_dict({'weight': torch.from_numpy(w.copy()),
                        'bn_scale': torch.from_numpy(params['BatchNorm_0']['scale']),
                        'bn_bias': torch.from_numpy(params['BatchNorm_0']['bias']),
                        'bn_mean': torch.zeros(cout), 'bn_var': torch.ones(cout)})
    for x in (x1, x2):
        with jax.default_matmul_precision('highest'):
            jy, mut = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x),
                               True, mutable=['batch_stats'])
        stats = mut['batch_stats']
        ty = tm(torch.from_numpy(x).permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
        # One conv and one normalization in f32 in two libraries.
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tm.bn_mean.numpy(),
                                   np.asarray(stats['BatchNorm_0']['mean']), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.bn_var.numpy(),
                                   np.asarray(stats['BatchNorm_0']['var']), rtol=1e-5, atol=1e-6)
    with jax.default_matmul_precision('highest'):
        jy = jm.apply({'params': params, 'batch_stats': stats}, jnp.asarray(x1), False)
    ty = tm(torch.from_numpy(x1).permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_flax_batchnorm_is_not_torch_batchnorm():
    """Why SlimConv writes BatchNorm out: after one training batch
    nn.BatchNorm2d(momentum=0.1) holds the unbiased variance, flax the
    biased one."""
    rng = np.random.RandomState(0)
    y = rng.randn(2, 3, 4, 4).astype(np.float32)
    bn = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
    bn(torch.from_numpy(y))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    yj = jnp.asarray(y.transpose(0, 2, 3, 1))
    _, mut = jbn.apply(jbn.init(jax.random.PRNGKey(0), yj), yj, mutable=['batch_stats'])
    jvar = np.asarray(mut['batch_stats']['var'])
    n = 2 * 4 * 4
    np.testing.assert_allclose((bn.running_var.numpy() - 0.9) * (n - 1) / n + 0.9, jvar,
                               rtol=1e-5)
    assert np.abs(bn.running_var.numpy() - jvar).max() > 1e-3


def test_ae_init_params_distributions():
    cfg, _ = tiny_configs(tconfig)
    ae = tae.init_params(tae.CVPRAutoencoder(cfg, device='cpu'), seed=3)
    h2 = ae.encoder.h2                       # 5x5, 64 -> 128
    limit = np.sqrt(6.0 / ((64 + 128) * 25))
    w = h2.weight.detach().numpy()
    assert w.shape == (128, 64, 5, 5)
    assert np.abs(w).max() <= limit and np.abs(w).max() > 0.99 * limit
    np.testing.assert_allclose(w.std(), limit / np.sqrt(3), rtol=2e-2)
    t = ae.decoder.from_bn                   # transposed 3x3, 4 -> 128
    assert np.abs(t.weight.detach().numpy()).max() <= np.sqrt(6.0 / ((4 + 128) * 9))
    assert float(h2.bn_scale.detach().min()) == 1.0
    assert float(h2.bn_bias.detach().abs().max()) == 0.0
    assert float(h2.bn_mean.abs().max()) == 0.0 and float(h2.bn_var.min()) == 1.0
    c = ae.encoder.centers.detach().numpy()
    assert c.shape == (6,) and np.all(np.abs(c) <= 2) and len(set(c.tolist())) == 6
    again = tae.init_params(tae.CVPRAutoencoder(cfg, device='cpu'), seed=3)
    assert torch.equal(again.encoder.h2.weight, h2.weight)


# ---------------------------------------------------------------------------
# Metrics, distortions, losses
# ---------------------------------------------------------------------------

def test_metrics_int_cast_and_identical_images():
    a = np.array([[[[1.9, -1.9, 254.99]]]], np.float32)
    b = np.array([[[[1.0, -1.0, 254.0]]]], np.float32)
    # int32 casts truncate toward zero on both sides: no error is left.
    assert float(tmetrics.mse_per_image(torch.from_numpy(a), torch.from_numpy(b), True)) == 0.0
    assert np.isinf(float(tmetrics.psnr_per_image(torch.from_numpy(a), torch.from_numpy(b), True)))
    assert float(tmetrics.mse_per_image(torch.from_numpy(a), torch.from_numpy(b), False)) > 0.5


@pytest.mark.parametrize('is_training', [True, False])
@pytest.mark.parametrize('minimize_for', ['mse', 'psnr', 'ms_ssim'])
def test_distortions_compute_matches_jax(minimize_for, is_training):
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 32, 32, 3) * 255).astype(np.float32)
    y = np.clip(x + rng.randn(2, 32, 32, 3).astype(np.float32) * 20, 0, 255)
    jcfg, _ = tiny_configs(jconfig, distortion_to_minimize=minimize_for)
    tcfg, _ = tiny_configs(tconfig, distortion_to_minimize=minimize_for)
    jd, jc = jdist.compute(jcfg, jnp.asarray(x), jnp.asarray(y), is_training)
    yt = torch.from_numpy(y).requires_grad_()
    td, tc = tdist.compute(tcfg, torch.from_numpy(x), yt, is_training)
    assert set(tc) == set(jc)
    # f32 means over 6144 pixels; ms_ssim's fractional powers amplify them.
    np.testing.assert_allclose(float(td), float(jd), rtol=2e-5)
    for k in jc:
        np.testing.assert_allclose(float(tc[k]), float(jc[k]), rtol=2e-5)
    if is_training or minimize_for == 'ms_ssim':
        jg = jax.grad(lambda yj: jdist.compute(jcfg, jnp.asarray(x), yj, is_training)[0])(
            jnp.asarray(y))
        td.backward()
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-4 * scale)
    else:
        assert not td.requires_grad       # behind the int cast: no gradient


@pytest.mark.parametrize('heatmap', [True, False])
def test_total_loss_comps_match_jax(heatmap):
    rng = np.random.RandomState(6)
    jae_cfg, jpc_cfg = tiny_configs(jconfig)
    tae_cfg, tpc_cfg = tiny_configs(tconfig)
    jpc_cfg = jpc_cfg.replace(regularization_factor=0.01)
    tpc_cfg = tpc_cfg.replace(regularization_factor=0.01)
    st = _jax_init_state()
    ae = tae.CVPRAutoencoder(tae_cfg, device='cpu')
    pc = tpc.ProbClassifier(tpc_cfg, 6, device='cpu')
    ae.load_state_dict(tweights.ae_state_dict(_np_tree(st.params['ae']),
                                              _np_tree(st.batch_stats), ae))
    pc.load_state_dict(tweights.pc_state_dict(_np_tree(st.params['pc'])))
    bc = (rng.rand(2, 4, 4, 4) * 3).astype(np.float32)
    hm = rng.rand(2, 4, 4, 4).astype(np.float32) if heatmap else None
    centers = st.params['ae']['encoder']['centers']
    jtotal, jcomps = jlosses.total_loss(jae_cfg, jpc_cfg, jnp.float32(123.0), jnp.asarray(bc),
                                        None if hm is None else jnp.asarray(hm),
                                        st.params['ae'], st.params['pc'], centers)
    ttotal, tcomps = tlosses.total_loss(tae_cfg, tpc_cfg, torch.tensor(123.0),
                                        torch.from_numpy(bc),
                                        None if hm is None else torch.from_numpy(hm),
                                        ae, pc, ae.encoder.centers)
    assert set(tcomps) == set(jcomps)
    for k in jcomps:    # sums of squares over ~1e6 weights in another order
        np.testing.assert_allclose(float(tcomps[k]), float(jcomps[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)
    assert float(tcomps['reg_pc']) > 0
    if not heatmap:
        assert float(tcomps['H_mask']) == float(tcomps['H_real'])


def test_l2_of_conv_kernels_takes_only_conv_kernels():
    tae_cfg, tpc_cfg = tiny_configs(tconfig)
    ae = tae.init_params(tae.CVPRAutoencoder(tae_cfg, device='cpu'), 0)
    pc = tpc.init_params(tpc.ProbClassifier(tpc_cfg, 6, device='cpu'), 1)
    want = sum(0.5 * float((p.double() ** 2).sum()) for n, p in ae.named_parameters()
               if n.endswith('.weight'))
    np.testing.assert_allclose(float(tlosses.l2_of_conv_kernels(ae)), want, rtol=1e-5)
    # The raw 3-D weight, masked taps included; biases excluded.
    want = sum(0.5 * float((p.double() ** 2).sum()) for n, p in pc.named_parameters()
               if n.endswith('.weight'))
    np.testing.assert_allclose(float(tlosses.l2_of_conv_kernels(pc)), want, rtol=1e-5)
    with torch.no_grad():
        for m in ae.modules():
            if isinstance(m, tae.SlimConv):
                m.bn_scale.fill_(7.0)
        ae.encoder.centers.fill_(9.0)
        pc.net.conv0.bias.fill_(5.0)
    np.testing.assert_allclose(float(tlosses.l2_of_conv_kernels(pc)), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Schedules and optimizer groups
# ---------------------------------------------------------------------------

def test_lr_schedule_staircase_matches_optax():
    jcfg, _ = tiny_configs(jconfig)
    tcfg, _ = tiny_configs(tconfig)
    sched = topt.make_schedule(tcfg, itr_per_epoch=10)
    jsched = jopt.make_schedule(jcfg, itr_per_epoch=10)
    # decay_interval = 2 epochs => a transition every 20 steps, rate 0.1
    assert sched(0) == pytest.approx(tcfg.lr_initial)
    assert sched(19) == pytest.approx(tcfg.lr_initial)
    assert sched(20) == pytest.approx(tcfg.lr_initial * 0.1, rel=1e-4)
    assert sched(45) == pytest.approx(tcfg.lr_initial * 0.01, rel=1e-4)
    for step in (0, 1, 19, 20, 21, 39, 40, 45, 100):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-5)
    smooth = topt.make_schedule(tcfg.replace(lr_schedule_decay_staircase=False), 10)
    jsmooth = jopt.make_schedule(jcfg.replace(lr_schedule_decay_staircase=False), 10)
    assert smooth(7) == pytest.approx(float(jsmooth(7)), rel=1e-5)
    assert topt.make_schedule(tcfg.replace(lr_schedule='FIXED'), 10)(1000) == tcfg.lr_initial


def test_num_itr_per_epoch():
    assert topt.num_itr_per_epoch(100, 10, 1) == 10
    assert topt.num_itr_per_epoch(100, 10, 2) == 20
    assert topt.num_itr_per_epoch(3, 30, 1) == 1


def test_optimizer_groups_follow_their_schedules():
    """The rate each group uses at update i is schedule(i), i from 0; the
    centers group runs at lr_ae * lr_centers_factor."""
    ae_cfg, pc_cfg = tiny_configs(tconfig, lr_centers_factor=0.1)
    t = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=4, device='cpu')   # 2 itr / epoch
    state = t.init_state(0)
    assert set(state.optimizer.optimizers) == {'ae', 'centers', 'pc'}
    assert len(state.optimizer.optimizers['centers'].param_groups[0]['params']) == 1
    n_ae = sum(1 for _ in state.ae.parameters())
    assert len(state.optimizer.optimizers['ae'].param_groups[0]['params']) == n_ae - 1
    for step in range(6):       # a transition every 4 steps
        lrs = state.optimizer.learning_rates()
        want = ae_cfg.lr_initial * 0.1 ** (step // 4)
        assert lrs['ae'] == pytest.approx(want, rel=1e-6)
        assert lrs['centers'] == pytest.approx(want * 0.1, rel=1e-6)
        assert lrs['pc'] == pytest.approx(pc_cfg.lr_initial * 0.1 ** (step // 4), rel=1e-6)
        for p in list(state.ae.parameters()) + list(state.pc.parameters()):
            p.grad = torch.zeros_like(p)
        state.optimizer.step()


def test_lr_centers_factor_group_moves_centers_less():
    """One Adam step moves every coordinate by ~its group's rate."""
    ae_cfg, pc_cfg = tiny_configs(tconfig, lr_centers_factor=0.1, lr_schedule='FIXED')
    t = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    c0 = state.ae.encoder.centers.detach().clone()
    w0 = state.ae.encoder.h1.weight.detach().clone()
    t.train_step(state, _batch())
    dc = (state.ae.encoder.centers.detach() - c0).abs().max().item()
    dw = (state.ae.encoder.h1.weight.detach() - w0).abs().max().item()
    assert 0 < dc <= 0.1 * ae_cfg.lr_initial * 1.01
    assert 0.9 * ae_cfg.lr_initial < dw <= ae_cfg.lr_initial * 1.01


@pytest.mark.parametrize('frozen', ['train_autoencoder', 'train_probclass'])
def test_frozen_group_keeps_parameters_but_batchnorm_moves(frozen):
    ae_cfg, pc_cfg = tiny_configs(tconfig, **{frozen: False})
    t = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    before = {n: p.detach().clone() for n, p in state.ae.named_parameters()}
    before_pc = {n: p.detach().clone() for n, p in state.pc.named_parameters()}
    mean0 = state.ae.encoder.h1.bn_mean.clone()
    t.train_step(state, _batch())
    ae_moved = any(not torch.equal(p, before[n]) for n, p in state.ae.named_parameters())
    pc_moved = any(not torch.equal(p, before_pc[n]) for n, p in state.pc.named_parameters())
    assert ae_moved == (frozen != 'train_autoencoder')
    assert pc_moved == (frozen != 'train_probclass')
    assert not torch.equal(state.ae.encoder.h1.bn_mean, mean0)


@pytest.mark.parametrize('optimizer', ['SGD', 'MOMENTUM'])
def test_sgd_and_momentum_match_optax(optimizer):
    """Two updates of one group on fixed gradients against optax."""
    jcfg, _ = tiny_configs(jconfig, optimizer=optimizer, lr_schedule='FIXED')
    tcfg, _ = tiny_configs(tconfig, optimizer=optimizer, lr_schedule='FIXED')
    rng = np.random.RandomState(8)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(2)]
    jo = jopt.make_single_optimizer(jcfg, jopt.make_schedule(jcfg, 10))
    jp = jnp.asarray(p0)
    jstate = jo.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    to = topt.make_single_optimizer(tcfg, [p])
    sched = torch.optim.lr_scheduler.LambdaLR(to, topt.make_schedule(tcfg, 10))
    for g in grads:
        upd, jstate = jo.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        to.step()
        sched.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# The differentiable pad value (centers[0], learn_pad_var)
# ---------------------------------------------------------------------------

def _pc_pair(learn_pad_var, seed=1, shape=(1, 6, 7, 4)):
    jcfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    jcfg = jcfg.replace(arch_param__k=8, learn_pad_var=learn_pad_var)
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tcfg = tcfg.replace(arch_param__k=8, learn_pad_var=learn_pad_var)
    jm = jpc.ProbClassifier(jcfg, 6)
    params = jax.jit(lambda key: jm.init(key, shape))(jax.random.PRNGKey(seed))
    if learn_pad_var:
        params = _np_tree(params)
        params['params']['pad_var'] = np.float32(0.3)
    tm = tpc.ProbClassifier(tcfg, 6, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(_np_tree(params)), strict=True)
    return jcfg, jm, params, tcfg, tm


@pytest.mark.parametrize('learn_pad_var', [False, True])
def test_rate_loss_differentiates_into_the_pad_value(learn_pad_var):
    """sum(bitcost) differentiates into centers[0] through the padding, or
    into pad_var when learn_pad_var is set (cf. tests/test_pad_var.py), and
    the gradient matches JAX's."""
    jcfg, jm, params, tcfg, tm = _pc_pair(learn_pad_var)
    rng = np.random.RandomState(0)
    c_np = np.linspace(-2, 2, 6).astype(np.float32)
    q = rng.rand(1, 6, 7, 4).astype(np.float32)
    syms = rng.randint(0, 6, (1, 6, 7, 4))

    def jloss(p, c):
        pad = jpc.auto_pad_value(jcfg, c, p)
        return jnp.sum(jm.bitcost(p, jnp.asarray(q), jnp.asarray(syms), pad_value=pad))

    with jax.default_matmul_precision('highest'):
        jl, (gp, gc) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            params, jnp.asarray(c_np))
    centers = torch.from_numpy(c_np).requires_grad_()
    pad = tpc.auto_pad_value(tcfg, centers, tm)
    assert pad.ndim == 0
    tl = tm.bitcost(torch.from_numpy(q), torch.from_numpy(syms), pad).sum()
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    if learn_pad_var:
        assert 'net.pad_var' in tm.state_dict()
        want = float(gp['params']['pad_var'])
        assert abs(want) > 0
        np.testing.assert_allclose(float(tm.net.pad_var.grad), want, rtol=1e-4)
        assert centers.grad is None
        with pytest.raises(ValueError, match='learn_pad_var'):
            tpc.auto_pad_value(tcfg, centers)
    else:
        assert 'net.pad_var' not in tm.state_dict()
        want = np.asarray(gc)
        assert abs(want[0]) > 0 and np.all(want[1:] == 0)
        np.testing.assert_allclose(centers.grad.numpy(), want, rtol=1e-4, atol=1e-6)
    # every context-model gradient, through the flax-shaped tree
    tg = _flat(tweights.pc_tree({n: p.grad for n, p in tm.named_parameters()}))
    jg = _flat(_np_tree(gp['params']))
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(jg[k]).max(), err_msg='/'.join(k))


def test_pad_volume_accepts_numbers_and_tensors():
    v = torch.arange(24, dtype=torch.float32).reshape(1, 2, 3, 4)
    a = tpc.pad_volume(v, 9, -2.0)
    b = tpc.pad_volume(v, 9, torch.tensor(-2.0))
    assert a.shape == (1, 6, 11, 12) and torch.equal(a, b)
    assert float(a[0, 0, 0, 0]) == -2.0 and torch.equal(a[:, 4:, 4:-4, 4:-4], v)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _batch(seed=0, n=2, hw=32):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, hw, hw, 3) * 255).astype(np.float32)


def _carried(jt, jstate, tt):
    """A port TrainState holding the JAX state's weights."""
    ts = tt.init_state(0)
    ts.ae.load_state_dict(tweights.ae_state_dict(_np_tree(jstate.params['ae']),
                                                 _np_tree(jstate.batch_stats), ts.ae))
    ts.pc.load_state_dict(tweights.pc_state_dict(_np_tree(jstate.params['pc'])))
    return ts


def _port_grad_trees(ts):
    ae_g, _ = tweights.ae_trees({n: p.grad for n, p in ts.ae.named_parameters()}, ts.ae)
    return {'ae': ae_g,
            'pc': tweights.pc_tree({n: p.grad for n, p in ts.pc.named_parameters()})}


@pytest.mark.parametrize('minimize_for,crop,quant_impl,batch_seed', [
    ('mse', 32, 'xla', 0),
    ('ms_ssim', 32, 'xla', 0),
    ('ms_ssim', 32, 'pallas', 0),
])
def test_loss_comps_and_every_gradient_match_jax(monkeypatch, minimize_for, crop,
                                                 quant_impl, batch_seed):
    """Same weights, same batch: total loss, every comps entry, every
    parameter gradient and the moved BatchNorm statistics against
    jax.value_and_grad(Trainer._loss_fn). With 'pallas' the JAX side runs the
    Pallas forward and backward kernels in interpret mode."""
    monkeypatch.setenv('IMGCOMP_QUANT_IMPL', quant_impl)
    over = dict(distortion_to_minimize=minimize_for, crop_size=(crop, crop))
    jae_cfg, jpc_cfg = tiny_configs(jconfig, **over)
    tae_cfg, tpc_cfg = tiny_configs(tconfig, **over)
    jt = jtrainer.Trainer(jae_cfg, jpc_cfg, num_train_images=64)
    jstate = _jax_init_state()
    batch = _batch(batch_seed, hw=crop)
    # Jitted: op-by-op dispatch of the same graph compiles every op on its own.
    with jax.default_matmul_precision('highest'):
        (jl, (jstats, jcomps)), jg = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
            jstate.params, jstate.batch_stats, jnp.asarray(batch))
        jsym = jax.jit(lambda p, s, b: jt.ae.apply(
            {'params': p, 'batch_stats': s}, b, True,
            mutable=['batch_stats'])[0][0].symbols)(
                jstate.params['ae'], jstate.batch_stats, jnp.asarray(batch))

    tt = ttrainer.Trainer(tae_cfg, tpc_cfg, num_train_images=64, device='cpu')
    ts = _carried(jt, jstate, tt)
    with torch.no_grad():
        tsym = ts.ae.encoder(torch.from_numpy(batch), True).symbols.numpy()
    ts = _carried(jt, jstate, tt)           # the probe above moved the BN statistics
    total, comps = tt.loss_fn(ts, batch)
    total.backward()

    # A symbol that flips moves bitcost and the decoder input by a whole
    # step: the comparison below is of runs with identical symbols.
    flips = int((tsym != np.asarray(jsym)).sum())
    assert flips == 0, f'{flips} symbol flips of {tsym.size}'
    assert set(comps) == set(jcomps) == {
        'total_loss', 'd_loss_scaled', 'pc_loss', 'H_real', 'H_mask', 'H_soft', 'reg_ae',
        'reg_centers', 'reg_pc', 'mse', 'psnr', 'bpp'} | (
            {'ms_ssim'} if minimize_for == 'ms_ssim' else set())
    # f32 forward through ~12 convs with batch statistics in two libraries.
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    for k in jcomps:
        np.testing.assert_allclose(float(comps[k]), float(jcomps[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    tg, jgn = _port_grad_trees(ts), _np_tree(jg)
    n_leaves = 0
    for part in ('ae', 'pc'):
        a, b = _flat(jgn[part]), _flat(tg[part])
        assert set(a) == set(b)
        for k in a:
            # Measured ~1e-5 of the leaf's largest entry; 1e-3 leaves room for
            # the backward's other summation order through the BN statistics.
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-3 * np.abs(a[k]).max() + 1e-12,
                                       err_msg=f'{part}/' + '/'.join(k))
            n_leaves += 1
    assert n_leaves == sum(1 for _ in ts.ae.parameters()) + sum(1 for _ in ts.pc.parameters())
    _, tstats = tweights.ae_trees(ts.ae.state_dict(), ts.ae)
    a, b = _flat(_np_tree(jstats)), _flat(tstats)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5, err_msg='/'.join(k))


def test_five_adam_steps_track_jax():
    """Five train steps on one batch from carried weights: the loss
    trajectory and the parameters stay with the JAX trainer's."""
    jae_cfg, jpc_cfg = tiny_configs(jconfig)
    tae_cfg, tpc_cfg = tiny_configs(tconfig)
    jt = jtrainer.Trainer(jae_cfg, jpc_cfg, num_train_images=64)
    jstate = _jax_init_state()
    tt = ttrainer.Trainer(tae_cfg, tpc_cfg, num_train_images=64, device='cpu')
    ts = _carried(jt, jstate, tt)
    p0 = _np_tree(jstate.params)
    batch = _batch()
    jlosses_, tlosses_, flips = [], [], 0
    for _ in range(5):
        with jax.default_matmul_precision('highest'):
            jstate, jc = jt.train_step(jstate, jnp.asarray(batch))
        ts, tc = tt.train_step(ts, batch)
        jlosses_.append(float(jc['total_loss']))
        tlosses_.append(float(tc['total_loss']))
    assert ts.step == int(jstate.step) == 5
    assert tlosses_[-1] < tlosses_[0]
    # Adam's first steps are lr * sign-like: a 1e-5 gradient difference can
    # move a step by far more than 1e-5 of it where the gradient is near 0,
    # so the trajectories are held to 1e-3, not to rounding.
    np.testing.assert_allclose(tlosses_, jlosses_, rtol=1e-3)
    ae_p, _ = tweights.ae_trees({n: p for n, p in ts.ae.named_parameters()}, ts.ae)
    tparams = {'ae': ae_p, 'pc': tweights.pc_tree(dict(ts.pc.named_parameters()))}
    jparams = _np_tree(jstate.params)
    lr = max(tae_cfg.lr_initial, tpc_cfg.lr_initial)
    for part in ('ae', 'pc'):
        a, b, start = _flat(jparams[part]), _flat(tparams[part]), _flat(p0[part])
        for k in a:
            # Each run moved every coordinate by at most 5 * lr. Where a
            # gradient is near 0 its sign, and so Adam's step, can differ
            # between the runs: a few entries may part by up to 2 * 5 * lr,
            # all others agree to a hundredth of the distance travelled.
            assert np.abs(a[k] - start[k]).max() <= 5 * lr * 1.01
            diff = np.abs(b[k] - a[k])
            assert diff.max() <= 10 * lr * 1.01, '/'.join(k)
            assert (diff > 0.05 * lr).mean() <= 1e-3, ('/'.join(k), (diff > 0.05 * lr).mean())
    with torch.no_grad():
        tsym = ts.ae.encode(torch.from_numpy(batch)).symbols.numpy()
    jsym = np.asarray(jt.ae.apply({'params': jstate.params['ae'],
                                   'batch_stats': jstate.batch_stats},
                                  jnp.asarray(batch), False, method='encode').symbols)
    flips = int((tsym != jsym).sum())
    assert flips <= 0.01 * tsym.size, f'{flips} symbol flips of {tsym.size} after 5 steps'


def test_eval_step_matches_jax():
    jae_cfg, jpc_cfg = tiny_configs(jconfig, distortion_to_minimize='ms_ssim')
    tae_cfg, tpc_cfg = tiny_configs(tconfig, distortion_to_minimize='ms_ssim')
    jt = jtrainer.Trainer(jae_cfg, jpc_cfg, num_train_images=64)
    jstate = _jax_init_state()
    tt = ttrainer.Trainer(tae_cfg, tpc_cfg, num_train_images=64, device='cpu')
    ts = _carried(jt, jstate, tt)
    batch = _batch(3).astype(np.uint8)
    with jax.default_matmul_precision('highest'):
        jout = jt.eval_step(jstate, jnp.asarray(batch))
    tout = tt.eval_step(ts, batch)
    assert set(tout) == set(jout) == {'mse', 'psnr', 'ms_ssim', 'bpp', 'ms_ssim_eval'}
    for k in jout:      # mse/psnr are of int-cast pixels: a rounding can move one pixel by 1
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-4, err_msg=k)


def test_train_step_without_heatmap_and_with_pad_var():
    ae_cfg, pc_cfg = tiny_configs(tconfig, heatmap=False)
    pc_cfg = pc_cfg.replace(learn_pad_var=True)
    t = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    assert state.ae.encoder.to_bn.weight.shape[0] == ae_cfg.num_chan_bn
    v0 = float(state.pc.net.pad_var)
    losses = []
    for _ in range(3):
        state, comps = t.train_step(state, _batch())
        losses.append(float(comps['total_loss']))
    assert np.isfinite(losses).all()
    assert float(comps['H_mask']) == float(comps['H_real'])     # no mask term
    assert float(state.pc.net.pad_var) != v0, 'pad_var did not move under training'


def test_train_steps_decrease_loss_and_move_everything():
    """The JAX test's criterion (tests/test_training.py:31-41) on the port,
    with ms_ssim as the distortion at a 32x32 crop."""
    ae_cfg, pc_cfg = tiny_configs(tconfig, distortion_to_minimize='ms_ssim')
    t = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    before = {n: v.detach().clone() for n, v in list(state.ae.state_dict().items())
              + list(state.pc.state_dict().items())}
    batch = _batch().astype(np.uint8)
    losses = []
    for _ in range(8):
        state, comps = t.train_step(state, batch)
        losses.append(float(comps['total_loss']))
        assert all(np.isfinite(float(v)) for v in comps.values())
    assert state.step == 8 and losses[-1] < losses[0], losses
    after = dict(list(state.ae.state_dict().items()) + list(state.pc.state_dict().items()))
    unmoved = [n for n in before if torch.equal(before[n], after[n])]
    assert not unmoved, unmoved


def test_trainer_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    ae_cfg, pc_cfg = tiny_configs(tconfig)
    with pytest.raises(RuntimeError, match='cuda'):
        ttrainer.Trainer(ae_cfg, pc_cfg)
