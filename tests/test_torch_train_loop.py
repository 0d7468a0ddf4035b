"""The port's training infrastructure on the CPU: the synthetic dataset and
input pipeline against the JAX package's, checkpoint save / restore / skip
conventions, the weight carrier both ways, and train_loop.train end to end
with tiny configs (train, test interval, save, restore and continue).
"""

import json
import os

import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.data import pipeline as jpipeline
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.data import pipeline as tpipeline
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
from imgcomp_cvpr_tpu_torch.training import train_loop as tloop
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir

from test_e2e import TINY_AE, TINY_PC


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     'assets', 'demo_trained_low_9000.npz')


def tiny_configs(**ae_over):
    ae, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    over = dict(arch_param_B=1, num_chan_bn=4, batch_size=2, crop_size=(32, 32),
                distortion_to_minimize='mse')
    over.update(ae_over)
    return ae.replace(**over), pc.replace(arch_param__k=4)


def _batch(seed=0):
    return (np.random.RandomState(seed).rand(2, 32, 32, 3) * 255).astype(np.uint8)


@pytest.fixture(scope='module')
def tiny_trainer():
    ae, pc = tiny_configs()
    return ttrainer.Trainer(ae, pc, num_train_images=64, device='cpu')


# ---------------- pipeline ----------------

@pytest.mark.parametrize('idx', [0, 5])
def test_synthetic_dataset_is_the_jax_packages(idx):
    a = tpipeline.get_dataset('synthetic:8')
    b = jpipeline.get_dataset('synthetic:8')
    assert a.num_images == b.num_images == 8
    img = a.load(idx)
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(img, b.load(idx))


def test_synthetic_pipeline_batches_match_jax():
    """Same seed, one worker: the port's batches are the JAX package's."""
    kw = dict(crop_size=(32, 32), batch_size=4, num_preprocess_threads=1,
              num_crops_per_img=2, seed=3)
    a = tpipeline.InputPipeline(tpipeline.get_dataset('synthetic:8'), **kw).start()
    b = jpipeline.InputPipeline(jpipeline.get_dataset('synthetic:8'), **kw).start()
    try:
        for _ in range(3):
            ba, bb = a.get_batch(), b.get_batch()
            assert ba.shape == (4, 32, 32, 3) and ba.dtype == np.uint8
            np.testing.assert_array_equal(ba, bb)
    finally:
        a.stop()
        b.stop()
    assert not a._threads


@pytest.mark.parametrize('spec', ['natural:4', 'imgnet_train', '/no/such/dir', '*.tfrecord'])
def test_other_dataset_kinds_are_not_ported(spec):
    """These specs once raised NotImplementedError in the port; each now
    resolves as the JAX package's get_dataset does: 'natural:4' to the same
    images, the rest (no shards under $RECORDS_ROOT, no such directory, no
    matching shard) to its ValueError. tests/test_torch_data.py covers
    every kind in full."""
    if spec == 'natural:4':
        a, b = tpipeline.get_dataset(spec), jpipeline.get_dataset(spec)
        assert a.name == b.name == 'natural' and a.paths == b.paths
        np.testing.assert_array_equal(a.load(3), b.load(3))
        return
    for get in (tpipeline.get_dataset, jpipeline.get_dataset):
        with pytest.raises(ValueError):
            get(spec)


# ---------------- weights, both ways ----------------

def test_weight_carrier_round_trips_the_trained_tree():
    tree = tweights.load_npz(ASSET)
    ae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    ae = tae.CVPRAutoencoder(ae_cfg, device='cpu')
    pc = tpc.ProbClassifier(pc_cfg, ae_cfg.num_centers, device='cpu')
    tweights.load_trained(ASSET, ae, pc, device='cpu')
    params, stats = tweights.ae_trees(ae.state_dict(), ae)
    for want, got in ((tree['params']['ae'], params), (tree['batch_stats'], stats),
                      (tree['params']['pc'], tweights.pc_tree(pc.state_dict()))):
        a, b = tweights._flatten(want), tweights._flatten(got)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg='/'.join(k))
    with pytest.raises(KeyError):
        tweights.pc_tree({'net.conv0.gamma': torch.zeros(1)})


# ---------------- checkpointing ----------------

def _equal_trees(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_checkpoint_roundtrip(tmp_path, tiny_trainer):
    state = tiny_trainer.init_state(0)
    state, _ = tiny_trainer.train_step(state, _batch())
    saver = tckpt.Saver(str(tmp_path / 'ckpts'))
    p = saver.save(state.state_dict(), itr=1)
    assert os.path.basename(p) == 'ckpt-1'
    restored, itr = saver.restore()
    assert itr == 1
    _equal_trees(state.state_dict(), restored)
    names = json.load(open(tmp_path / 'ckpts' / tckpt.VAR_NAMES_FILE))
    assert 'model/ae/encoder.centers' in names and 'step' in names
    assert any(n.startswith('opt_state/optimizer/centers/') for n in names)


def test_checkpoint_restore_at_itr_and_retention(tmp_path, tiny_trainer):
    tree = tiny_trainer.init_state(0).state_dict()
    saver = tckpt.Saver(str(tmp_path / 'ckpts'), max_to_keep=10)
    for itr in (5, 10, 20):
        saver.save(dict(tree, step=itr), itr=itr)
    assert saver.restore(12)[1] == 10
    assert saver.restore()[1] == 20 and saver.restore(-1)[1] == 20
    assert saver.restore(12)[0]['step'] == 10
    assert [i for i, _ in tckpt.all_ckpts_with_iterations(str(tmp_path / 'ckpts'))] \
        == [5, 10, 20]
    with pytest.raises(FileNotFoundError):
        saver.restore(3)
    # max_to_keep=1 within one keep interval: the first and the latest stay
    keep1 = tckpt.Saver(str(tmp_path / 'k1'), max_to_keep=1, keep_every_n_hours=1.0)
    for itr in (1, 2, 3):
        keep1.save({'step': itr}, itr=itr)
    assert [i for i, _ in tckpt.all_ckpts_with_iterations(str(tmp_path / 'k1'))] == [1, 3]


def test_restore_continues_optimizer_and_schedule(tmp_path, tiny_trainer):
    """A restored state takes the same next step as the one that was saved."""
    t = tiny_trainer
    s1 = t.init_state(0)
    for i in range(2):
        t.train_step(s1, _batch(i))
    tckpt.Saver(str(tmp_path / 'ckpts')).save(s1.state_dict(), itr=2)
    fresh = t.init_state(7)
    fresh, itr = tckpt.RestoreManager(str(tmp_path / 'ckpts')).restore(fresh)
    assert itr == 2 and fresh.step == 2
    _equal_trees(s1.state_dict(), fresh.state_dict())
    _, c1 = t.train_step(s1, _batch(5))
    _, c2 = t.train_step(fresh, _batch(5))
    assert float(c1['total_loss']) == float(c2['total_loss'])
    _equal_trees(s1.state_dict(), fresh.state_dict())


def test_restore_with_skip(tmp_path, tiny_trainer):
    t = tiny_trainer
    s1 = t.init_state(0)
    t.train_step(s1, _batch())
    tckpt.Saver(str(tmp_path / 'ckpts')).save(s1.state_dict(), itr=1)

    class Flags:
        from_identity = str(tmp_path / 'ckpts')
    rm = tckpt.RestoreManager.from_flags(Flags)
    assert rm.skip_vars == ['opt_state', 'step'] and not rm.continue_in_ckpt_dir
    fresh = t.init_state(7)
    merged, itr = rm.restore(fresh)
    assert itr == 0 and merged.step == 0            # training restarts at 0
    _equal_trees(s1.state_dict()['model'], merged.state_dict()['model'])
    assert not merged.optimizer.optimizers['ae'].state_dict()['state']   # fresh moments
    # a pattern on one variable keeps that variable's fresh value only
    fresh = t.init_state(7)
    c_fresh = fresh.ae.encoder.centers.detach().clone()
    tckpt.RestoreManager(str(tmp_path / 'ckpts'), skip_vars=['centers']).restore(fresh)
    assert torch.equal(fresh.ae.encoder.centers.detach(), c_fresh)
    assert torch.equal(fresh.ae.encoder.h1.weight, s1.ae.encoder.h1.weight)
    assert fresh.step == 1


def test_restore_rejects_other_shapes(tmp_path, tiny_trainer):
    tckpt.Saver(str(tmp_path / 'ckpts')).save(tiny_trainer.init_state(0).state_dict(), itr=1)
    ae, pc = tiny_configs(num_chan_bn=8)
    other = ttrainer.Trainer(ae, pc, num_train_images=64, device='cpu').init_state(0)
    with pytest.raises(ValueError, match='checkpoint has'):
        tckpt.RestoreManager(str(tmp_path / 'ckpts')).restore(other)


def test_restore_manager_from_flags():
    class Flags:
        from_identity = None
        restore = '/x/ckpts'
        restore_itr = 30
        restore_continue = True
        restore_skip_vars = 'opt_state, step'
    rm = tckpt.RestoreManager.from_flags(Flags)
    assert (rm.itr, rm.continue_in_ckpt_dir, rm.skip_vars) == (30, True, ['opt_state', 'step'])
    assert rm.log_dir == '/x'
    Flags.restore = None
    assert tckpt.RestoreManager.from_flags(Flags) is None


# ---------------- the loop ----------------

@pytest.fixture
def config_roots(tmp_path, monkeypatch):
    ae_root, pc_root = tmp_path / 'cfg_ae', tmp_path / 'cfg_pc'
    ae_root.mkdir()
    pc_root.mkdir()
    (ae_root / 'tiny').write_text(TINY_AE)
    (pc_root / 'tiny_pc').write_text(TINY_PC)
    monkeypatch.setenv('CONFIG_BASE_AE', str(ae_root))
    monkeypatch.setenv('CONFIG_BASE_PC', str(pc_root))


def _events(log_dir, name):
    with open(os.path.join(log_dir, f'events_{name}.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_train_loop_end_to_end_and_restore(tmp_path, config_roots):
    """The configs of tests/test_e2e.py through the port's CLI: train 6
    steps with train / test logging and a save, then restore and continue
    in the same log dir from the saved iteration."""
    import train_torch
    log_root = str(tmp_path / 'logs')
    args = ['tiny', 'tiny_pc', '-dtrain', 'synthetic:4', '-dtest', 'synthetic:2',
            '-o', log_root, '--device', 'cpu', '-ltrain', '2', '-ltest', '3',
            '--steps_per_dispatch', '4']
    log_dir = train_torch.main(args + ['--max_steps', '6', '-lsave', '4'])
    assert os.path.isdir(log_dir) and tlogdir.is_log_date(os.path.basename(log_dir).split(' ')[0])
    assert os.path.basename(log_dir).endswith(' tiny tiny_pc')
    ckpt_dir = tlogdir.ckpt_dir_for_log_dir(log_dir)
    assert [i for i, _ in tckpt.all_ckpts_with_iterations(ckpt_dir)] == [4, 6]
    train_ev = _events(log_dir, 'train')
    assert [e['step'] for e in train_ev] == [2, 4, 6]
    assert {'total_loss', 'bpp', 'H_soft', 'mse', 'psnr', 'img_per_sec'} <= set(train_ev[0])
    assert all(np.isfinite(e['total_loss']) and e['img_per_sec'] > 0 for e in train_ev)
    test_ev = _events(log_dir, 'test')
    assert [e['step'] for e in test_ev] == [3, 6]
    assert {'bpp', 'mse', 'psnr', 'ms_ssim_eval'} <= set(test_ev[0])

    saved, _ = tckpt.Saver(ckpt_dir).restore()
    assert saved['step'] == 6
    log_dir2 = train_torch.main(args + ['--max_steps', '8', '--restore', ckpt_dir,
                                        '--restore_continue'])
    assert log_dir2 == log_dir
    assert [e['step'] for e in _events(log_dir, 'train')] == [2, 4, 6, 8]
    final, itr = tckpt.Saver(ckpt_dir).restore()
    assert itr == 8 and final['step'] == 8
    # the schedulers continued: 8 updates in all, not 2
    assert final['opt_state']['schedulers']['ae']['last_epoch'] == 8
    moved = final['model']['ae']['encoder.h1.weight'] - saved['model']['ae']['encoder.h1.weight']
    assert 0 < float(moved.abs().max()) <= 2 * 8e-5 * 1.01

    # without --restore_continue a new log dir is made, named after the old
    log_dir3 = tloop.train('tiny', 'tiny_pc', 'synthetic:4', 'synthetic:2',
                           log_dir_root=log_root, device='cpu',
                           restore_manager=tckpt.RestoreManager(ckpt_dir, itr=5),
                           flags=tloop.TrainFlags(log_interval_train=1, log_interval_test=-1,
                                                  max_steps=5))
    assert log_dir3 != log_dir and 'RESTORE@' in os.path.basename(log_dir3)
    assert [e['step'] for e in _events(log_dir3, 'train')] == [5]     # restored at 4


def test_train_loop_profiles_the_asked_steps(tmp_path, config_roots):
    """--profile_steps N traces steps [10, 10 + N) into <logdir>/profile."""
    log_dir = tloop.train('tiny', 'tiny_pc', 'synthetic:4', 'synthetic:2',
                          log_dir_root=str(tmp_path / 'logs'), device='cpu',
                          flags=tloop.TrainFlags(log_interval_train=100, log_interval_test=-1,
                                                 max_steps=12, profile_steps=1))
    trace = os.path.join(log_dir, 'profile', 'trace.json')
    assert os.path.getsize(trace) > 1000
    with open(trace) as f:
        assert 'traceEvents' in json.load(f)


def test_train_loop_raises_without_card(config_roots, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tloop.train('tiny', 'tiny_pc', log_dir_root=str(tmp_path / 'logs'))
    assert not os.path.exists(tmp_path / 'logs')
