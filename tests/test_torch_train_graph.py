"""The training step as one CUDA graph (training/trainer.py): where it is
used, when it is captured, warmed up and captured anew, and that it gives
the eager step's bits.

On the CPU the step stays eager, and the capture bookkeeping runs with a
stand-in graph that reruns the captured work at each replay. The tests
marked ``cuda`` hold the real graph to the eager step on the card, bit for
bit; they skip without one. This file imports no JAX: on the machine with
the card run it with ``python -m pytest --noconftest
tests/test_torch_train_graph.py``.
"""

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu_torch.ops.kernels import build
from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
from imgcomp_cvpr_tpu_torch.training import optimizers as opt_lib
from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
from imgcomp_cvpr_tpu_torch.utils import config as config_lib


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(ae_spec='cvpr/low_demo', tiny=True, **ae_over):
    ae, _ = config_lib.parse_spec(ae_spec, 'ae')
    pc, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    if tiny:
        ae_over = dict(dict(arch_param_B=1, num_chan_bn=4, distortion_to_minimize='mse'),
                       **ae_over)
        pc = pc.replace(arch_param__k=4)
    return ae.replace(**ae_over), pc


def batches(n, shape=(2, 32, 32, 3), seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*shape) * 255).astype(np.uint8) for _ in range(n)]


def snapshot(state):
    """Every number a step moves: parameters, BatchNorm statistics, each
    group's Adam state, the groups' rates; on the host."""
    out = {f'ae.{k}': v for k, v in state.ae.state_dict().items()}
    out.update({f'pc.{k}': v for k, v in state.pc.state_dict().items()})
    for name, opt in state.optimizer.optimizers.items():
        for i, p in enumerate(opt.param_groups[0]['params']):
            for k, v in opt.state.get(p, {}).items():
                out[f'{name}.{i}.{k}'] = v
        out[f'{name}.lr'] = torch.as_tensor(opt.param_groups[0]['lr'], dtype=torch.float32)
    return {k: v.detach().float().cpu().clone() for k, v in out.items()}


def assert_same(a, b):
    assert set(a) == set(b)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ


def counts():
    return build.LAUNCHES['train_graph_capture'], build.LAUNCHES['train_graph_replay']


def eager_run(trainer, state, steps, on_step=None):
    """The eager step in the graphed path's optimizer form, comps as floats."""
    out = []
    for i, batch in enumerate(steps):
        if on_step is not None:
            on_step(i, trainer, state)
        state.optimizer.make_capturable()
        _, comps = trainer._eager_step(state, batch)
        out.append({k: float(v) for k, v in comps.items()})
    return out


@pytest.fixture
def stand_in_graph(monkeypatch):
    """The graphed path on the CPU: no capture stream, the host form of the
    optimizer, and a graph that reruns the captured work at each replay
    into the same comps tensor, as a replay overwrites its outputs. The
    capture counts one launch each of kernels 1 and 7, as their wrappers do
    when the card's capture records them (on the CPU they count nothing)."""
    monkeypatch.setattr(trainer_lib.Trainer, '_graphs_on', lambda self, state: True)
    monkeypatch.setattr(trainer_lib.Trainer, '_capture_stream',
                        lambda self: contextlib.nullcontext())
    monkeypatch.setattr(opt_lib.GroupedOptimizer, 'make_capturable', lambda self: None)

    def capture(self, state, x):
        names, comps = [], torch.empty(0)
        build.LAUNCHES['quantize'] += 1
        build.LAUNCHES['quantize_bwd'] += 1

        class Graph:
            def replay(_):
                state.optimizer.zero_grad()
                n, c = self._graph_body(state, x)
                names[:] = n
                comps.resize_(c.shape).copy_(c)
        return Graph(), names, comps
    monkeypatch.setattr(trainer_lib.Trainer, '_capture', capture)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_cpu_step_stays_eager_and_unchanged():
    """On the CPU train_step is the eager step: no capture, no replay, the
    optimizer in its host form, and the bits of the step written out."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state, ref = t.init_state(0), t.init_state(0)
    build.reset_launches()
    data = batches(3)
    got, want = [], []
    for b in data:
        _, comps = t.train_step(state, b)
        got.append({k: float(v) for k, v in comps.items()})
        ref.optimizer.zero_grad()
        total, comps = t.loss_fn(ref, b)
        total.backward()
        for name, opt in ref.optimizer.optimizers.items():
            opt.step()
            ref.optimizer.schedulers[name].step()
        want.append({k: float(v.detach()) for k, v in comps.items()})
    assert counts() == (0, 0) and t._graph is None and t._warm is None
    for opt in state.optimizer.optimizers.values():
        assert not opt.param_groups[0]['capturable']
        assert isinstance(opt.param_groups[0]['lr'], float)
    assert got == want
    assert_same(snapshot(state), snapshot(ref))
    assert state.step == 3


def test_graphs_only_on_a_card_without_a_mesh():
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, device='cpu')
    adam = SimpleNamespace(optimizer=SimpleNamespace(graphable=True))
    sgd = SimpleNamespace(optimizer=SimpleNamespace(graphable=False))
    assert not t._graphs_on(adam)
    t.device = torch.device('cuda', 0)
    assert t._graphs_on(adam) and not t._graphs_on(sgd)
    dp = trainer_lib.Trainer(ae_cfg, pc_cfg, mesh=mesh_lib.Mesh(0, 1, torch.device('cuda', 0)))
    assert not dp._graphs_on(adam)


@pytest.mark.parametrize('optimizer,graphable', [('ADAM', True), ('SGD', False),
                                                 ('MOMENTUM', False)])
def test_graphable_groups_are_adam(optimizer, graphable):
    ae_cfg, pc_cfg = configs(optimizer=optimizer)
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, device='cpu')
    assert t.init_state(0).optimizer.graphable is graphable


def test_capture_key_warm_up_and_replays(stand_in_graph):
    """The first call for a key is eager, the second captures and replays,
    the rest replay; another batch shape warms up and captures anew, and
    the old graph goes. The steps equal the eager steps bit for bit."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state, ref = t.init_state(0), t.init_state(0)
    small, large = batches(4), batches(4, (3, 32, 32, 3), seed=1)
    data = small[:3] + large[:3] + small[3:]
    want_counts = [(0, 0), (1, 1), (1, 2), (1, 2), (2, 3), (2, 4), (2, 4)]
    build.reset_launches()
    got = []
    for b, want in zip(data, want_counts):
        _, comps = t.train_step(state, b)
        got.append({k: float(v) for k, v in comps.items()})
        assert counts() == want
        assert all(v.dim() == 0 for v in comps.values())
    assert t._graph is None and t._warm[0][3] == (2, 32, 32, 3)
    assert got == eager_run(t, ref, data)
    assert_same(snapshot(state), snapshot(ref))
    assert state.step == ref.step == 7


@pytest.mark.parametrize('reload', ['optimizer', 'state', 'new_state'])
def test_load_state_dict_and_a_new_state_capture_anew(stand_in_graph, reload):
    """A loaded optimizer state (directly or through TrainState) or another
    TrainState makes the next call a warm-up and the one after a capture;
    the run equals the eager run with the same load."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state, ref = t.init_state(0), t.init_state(0)
    data = batches(6)
    saved = {}

    def on_step(i, trainer, s):
        if i == 3:
            saved[id(s)] = copy.deepcopy(s.state_dict())
        if i == 4:
            if reload == 'optimizer':
                s.optimizer.load_state_dict(saved[id(s)]['opt_state'])
            else:
                s.load_state_dict(saved[id(s)])

    build.reset_launches()
    got, seen = [], []
    for i, b in enumerate(data):
        if reload == 'new_state' and i == 4:
            fresh = t.init_state(0)
            fresh.load_state_dict(saved[id(state)])
            state = fresh
        else:
            on_step(i, t, state)
        version = state.optimizer.version
        _, comps = t.train_step(state, b)
        got.append({k: float(v) for k, v in comps.items()})
        seen.append(counts())
    assert seen == [(0, 0), (1, 1), (1, 2), (1, 3), (1, 3), (2, 4)]
    assert version == 1
    assert t._graph is not None and t._warm[0][:3] == (id(state), id(state.optimizer), version)
    assert got == eager_run(t, ref, data, on_step)
    assert_same(snapshot(state), snapshot(ref))


def test_kernel_launches_count_at_each_replay(stand_in_graph):
    """What the wrappers counted while the step was captured is taken back
    then and added at each replay, so the launch counters count the
    kernels the card runs: one each a replayed step, none for the capture
    itself; a new capture keeps its own count."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    small, large = batches(3), batches(3, (3, 32, 32, 3), seed=1)
    build.reset_launches()
    seen = []
    for b in small + large:
        t.train_step(state, b)
        seen.append((*counts(), build.LAUNCHES['quantize'], build.LAUNCHES['quantize_bwd']))
    assert seen == [(0, 0, 0, 0), (1, 1, 1, 1), (1, 2, 2, 2),
                    (1, 2, 2, 2), (2, 3, 3, 3), (2, 4, 4, 4)]
    assert t._graph.launches == {'quantize': 1, 'quantize_bwd': 1}


def test_comps_of_a_step_outlive_the_next(stand_in_graph):
    """A replay overwrites the graph's outputs; the comps it returned are
    copies, so step i's stay as they were after step i + 1."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    data = batches(5)
    build.reset_launches()
    kept = []
    for b in data:
        _, comps = t.train_step(state, b)
        kept.append((comps, {k: v.clone() for k, v in comps.items()}))
    assert counts() == (1, 4)
    for comps, at_once in kept:
        assert_same(comps, at_once)
    assert kept[2][1]['total_loss'] != kept[3][1]['total_loss']
    assert set(kept[0][0]) == set(kept[-1][0])


def test_optimizer_saves_the_host_form(stand_in_graph):
    """The optimizers' state_dict gives float rates, capturable False and
    the step counters on the CPU, whatever form the groups run in."""
    ae_cfg, pc_cfg = configs()
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = t.init_state(0)
    for b in batches(2):
        t.train_step(state, b)
    for opt in state.optimizer.optimizers.values():     # as make_capturable leaves them
        opt.param_groups[0]['capturable'] = True
        opt.param_groups[0]['lr'] = torch.tensor(opt.param_groups[0]['lr'])
    sd = state.optimizer.state_dict()
    for name, osd in sd['optimizer'].items():
        group = osd['param_groups'][0]
        assert isinstance(group['lr'], float) and group['capturable'] is False
        assert all(st['step'].device.type == 'cpu' for st in osd['state'].values())
        live = state.optimizer.optimizers[name].param_groups[0]
        assert live['capturable'] is True and torch.is_tensor(live['lr'])


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_msssim_product_keeps_torch_prod_bits(dtype):
    """MS-SSIM's product of positive factors, whose backward has no test
    for zeros (it would wait for the card inside a captured step), gives
    torch.prod's value and gradient bit for bit."""
    from imgcomp_cvpr_tpu_torch.ops import msssim
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(4, generator=g, dtype=dtype) + 1e-6).requires_grad_()
    upstream = torch.rand((), generator=g, dtype=dtype)
    want = torch.prod(x)
    want.backward(upstream)
    want_grad, x.grad = x.grad, None
    got = msssim._ProdOfPositives.apply(x)
    got.backward(upstream)
    assert torch.equal(got, want) and torch.equal(x.grad, want_grad)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    """The card, with cuDNN's deterministic algorithms: its default backward
    sums in an order that changes from run to run, eager or graphed."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device('cuda', 0)
    torch.backends.cudnn.deterministic = was


def card_pair(dev, ae_spec='cvpr/low_demo', ae_over=None):
    """A graphed trainer and an eager one, each with a state from seed 0:
    cvpr/low widths at 48x48 crops, B=4, 8 images an epoch (2 steps)."""
    ae_cfg, pc_cfg = configs(ae_spec, tiny=False, batch_size=4, crop_size=(48, 48),
                             **(ae_over or {}))
    mk = lambda: trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=8, device=dev)
    tg, te = mk(), mk()
    return tg, tg.init_state(0), te, te.init_state(0)


def graphed_run(trainer, state, steps, on_step=None):
    out = []
    for i, b in enumerate(steps):
        if on_step is not None:
            on_step(i, trainer, state)
        _, comps = trainer.train_step(state, b)
        out.append(comps)
    return [{k: float(v) for k, v in c.items()} for c in out]


@pytest.mark.cuda
@pytest.mark.parametrize('schedule', ['FIXED', 'DECAY'])
def test_graphed_steps_equal_eager_steps_on_card(card, schedule):
    """Five steps, the last four graph replays, equal five eager steps bit
    for bit: parameters, BatchNorm statistics, Adam's moments and counters,
    the rates, comps. The context model's rate (pc base's DECAY, a
    transition every 2 epochs of 2 steps) changes inside the five; under
    the AE's DECAY (every epoch) its rate changes twice. An eval step after the replays sees the
    replayed weights."""
    tg, sg, te, se = card_pair(card, *(('cvpr/low_demo', {}) if schedule == 'FIXED' else
                                       ('cvpr/low', dict(lr_schedule_decay_interval=1))))
    data = [torch.from_numpy(b).to(card) for b in batches(5, (4, 48, 48, 3))]
    lr0 = sg.optimizer.learning_rates()
    build.reset_launches()
    got = graphed_run(tg, sg, data[:1])
    tg.eval_step(sg, data[0])      # folds the eval operands of the first step's weights
    got += graphed_run(tg, sg, data[1:])
    # kernels 1 and 7 once each a step, eager or replayed, kernel 1 once
    # more for the eval step
    assert (build.LAUNCHES['quantize'], build.LAUNCHES['quantize_bwd']) == (6, 5)
    want = eager_run(te, se, data)
    torch.cuda.synchronize()
    assert counts() == (1, 4)
    assert got == want
    assert_same(snapshot(sg), snapshot(se))
    ev_g = {k: float(v) for k, v in tg.eval_step(sg, data[0]).items()}
    ev_e = {k: float(v) for k, v in te.eval_step(se, data[0]).items()}
    assert ev_g == ev_e
    lr = sg.optimizer.learning_rates()
    want_ae = lr0['ae'] * (0.1 ** 2 if schedule == 'DECAY' else 1)
    assert lr['ae'] == pytest.approx(want_ae, rel=1e-6)
    assert lr['pc'] == pytest.approx(lr0['pc'] * 0.1, rel=1e-6)     # pc base: every 2 epochs


@pytest.mark.cuda
def test_new_batch_shape_captures_again_on_card(card):
    tg, sg, te, se = card_pair(card)
    small = [torch.from_numpy(b).to(card) for b in batches(3, (4, 48, 48, 3))]
    large = [torch.from_numpy(b).to(card) for b in batches(3, (6, 48, 48, 3), seed=1)]
    build.reset_launches()
    got = graphed_run(tg, sg, small + large)
    want = eager_run(te, se, small + large)
    torch.cuda.synchronize()
    assert counts() == (2, 4)
    assert got == want
    assert_same(snapshot(sg), snapshot(se))


@pytest.mark.cuda
def test_load_state_dict_mid_run_on_card(card):
    """The optimizer's state saved before the second step and loaded
    before the fourth: the fourth step warms up, the fifth captures anew,
    the sixth replays; equal to the eager run with the same load."""
    tg, sg, te, se = card_pair(card)
    data = [torch.from_numpy(b).to(card) for b in batches(6, (4, 48, 48, 3))]
    saved = {}

    def on_step(i, trainer, s):
        if i == 1:
            saved[id(s)] = copy.deepcopy(s.optimizer.state_dict())
        if i == 3:
            s.optimizer.load_state_dict(saved[id(s)])

    build.reset_launches()
    got = graphed_run(tg, sg, data, on_step)
    want = eager_run(te, se, data, on_step)
    torch.cuda.synchronize()
    assert counts() == (2, 4)
    assert got == want
    assert_same(snapshot(sg), snapshot(se))


@pytest.mark.cuda
def test_mesh_trainer_never_captures_on_card(card):
    """A trainer with a mesh (one rank under gloo on the card) takes the
    parent's step: no capture, the optimizer in its host form."""
    mesh = mesh_lib.init_process_group(0, 1, card, f'tcp://localhost:{mesh_lib.free_port()}',
                                       backend='gloo')
    try:
        ae_cfg, pc_cfg = configs('cvpr/low_demo', tiny=False, batch_size=4, crop_size=(48, 48))
        t = trainer_lib.Trainer(ae_cfg, pc_cfg, mesh=mesh)
        state = t.init_state(0)
        build.reset_launches()
        graphed_run(t, state, [torch.from_numpy(b).to(card) for b in batches(3, (4, 48, 48, 3))])
        torch.cuda.synchronize()
    finally:
        mesh_lib.destroy_process_group()
    assert counts() == (0, 0) and t._graph is None and t._warm is None
    for opt in state.optimizer.optimizers.values():
        assert not opt.param_groups[0]['capturable']
        assert isinstance(opt.param_groups[0]['lr'], float)


def bias_correction_error(beta, t):
    """Bound on the relative error of Adam's bias correction 1 - beta ** t
    as its capturable form takes it (float32 on the card: beta rounded to
    float32, the power within 4 ulps of a number below 1, CUDA's bound for
    powf) against the host form's (float64): the cancellation in 1 - x
    scales both roundings by 1 / (1 - beta ** t)."""
    exact = 1 - beta ** t
    return (abs(float(np.float32(beta)) ** t - beta ** t) + 4 * 2.0 ** -24) / exact


@pytest.mark.cuda
@pytest.mark.parametrize('schedule', ['FIXED', 'DECAY'])
def test_capturable_update_tracks_the_host_form_on_card(card, schedule):
    """Adam's capturable form, which the graphed path runs from its eager
    first call on, against the host form of the CPU and of a mesh, four
    times from one state and one batch: the capturable state is loaded
    from the host state before each update. The gradients are the same, so
    Adam's moments agree to an ulp and the step counters and the next
    rates (a DECAY rate changes inside the four) agree. Each parameter's
    update agrees to the float32 rounding of the bias corrections
    (bias_correction_error; ~6e-5 of the update at step 1, less later) and
    of the rate and the quotients (16 ulps), plus an ulp of the parameter
    on each side: a rate or a step counter that is off fails by orders of
    magnitude more."""
    ae_spec, over = (('cvpr/low_demo', {}) if schedule == 'FIXED' else
                     ('cvpr/low', dict(lr_schedule_decay_interval=1)))
    ae_cfg, pc_cfg = configs(ae_spec, tiny=False, batch_size=4, crop_size=(48, 48), **over)
    t = trainer_lib.Trainer(ae_cfg, pc_cfg, num_train_images=8, device=card)
    host, cap = t.init_state(0), t.init_state(0)
    eps = torch.finfo(torch.float32).eps
    lr0 = host.optimizer.learning_rates()
    for i, b in enumerate(batches(4, (4, 48, 48, 3))):
        b = torch.from_numpy(b).to(card)
        cap.load_state_dict(copy.deepcopy(host.state_dict()))
        cap.optimizer.make_capturable()
        rates = host.optimizer.learning_rates()
        before = {n: [p.detach().double().clone() for p in o.param_groups[0]['params']]
                  for n, o in host.optimizer.optimizers.items()}
        t._eager_step(host, b)
        t._eager_step(cap, b)
        torch.cuda.synchronize()
        for (name, oh), oc in zip(host.optimizer.optimizers.items(),
                                  cap.optimizer.optimizers.values()):
            assert oc.param_groups[0]['capturable'] and not oh.param_groups[0]['capturable']
            b1, b2 = oh.param_groups[0]['betas']
            tol = bias_correction_error(b1, i + 1) + bias_correction_error(b2, i + 1) / 2 \
                + 16 * eps
            moved = 0.0
            for p0, ph, pc in zip(before[name], oh.param_groups[0]['params'],
                                  oc.param_groups[0]['params']):
                sh, sc = oh.state[ph], oc.state[pc]
                assert float(sh['step']) == float(sc['step']) == i + 1
                for k in ('exp_avg', 'exp_avg_sq'):
                    torch.testing.assert_close(sc[k], sh[k], rtol=2 * eps, atol=0)
                ph, pc = ph.detach().double(), pc.detach().double()
                dh, dc = ph - p0, pc - p0
                slack = tol * dh.abs() + eps * (ph.abs() + pc.abs())
                worst = ((dc - dh).abs() - slack).max().item()
                assert worst <= 0, (name, i, worst)
                moved = max(moved, dh.abs().max().item())
            assert moved > rates[name] / 10, (name, i, moved, rates[name])
        for mh, mc in ((host.ae, cap.ae), (host.pc, cap.pc)):
            for (k, bh), bc in zip(mh.named_buffers(), mc.buffers()):
                assert torch.equal(bh, bc), k
        after_h, after_c = host.optimizer.learning_rates(), cap.optimizer.learning_rates()
        assert after_c == pytest.approx(after_h, rel=2 * eps)
    if schedule == 'DECAY':     # every epoch of 2 steps
        assert after_h['ae'] == pytest.approx(lr0['ae'] * 0.1 ** 2, rel=1e-6)
