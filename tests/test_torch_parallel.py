"""Data parallelism in the port (parallel/mesh.py) on the CPU: gloo ranks
in spawned processes against one device, against the JAX package's 2-device
mesh, data-parallel evaluation over a list of devices, and train_torch.py
--num_devices end to end. The bounds are the JAX test's own
(tests/test_parallel.py): loss rel 1e-5; parameters rtol 2e-2 / atol 5e-4
with a mean |delta| below 1e-6.
"""

import functools
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

# The spawned ranks import this module for rank_steps: what only the
# evaluation and entry-point tests need is imported there.
from imgcomp_cvpr_tpu_torch.parallel import mesh as tmesh
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread here and in the spawned ranks (they read
    OMP_NUM_THREADS when they import torch)."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_configs(mod, **ae_over):
    """tests/test_parallel.py::tiny_configs, from either package's parser."""
    ae, _ = mod.parse_spec('cvpr/low', 'ae')
    pc, _ = mod.parse_spec('cvpr/res_shallow', 'pc')
    over = dict(arch_param_B=1, num_chan_bn=4, batch_size=8, crop_size=(32, 32),
                distortion_to_minimize='mse')
    over.update(ae_over)
    return ae.replace(**over), pc.replace(arch_param__k=4)


def _batch(n, seed=0):
    return (np.random.RandomState(seed).rand(n, 32, 32, 3) * 255).astype(np.float32)


def recorded_step(trainer, state, batch):
    """trainer.train_step, also returning the gradients that the optimizer
    steps with (after the all-reduce of a data-parallel trainer), on the
    host, keyed 'ae.<name>' / 'pc.<name>'."""
    grads, step = {}, state.optimizer.step

    def recording():
        for part, mod in (('ae', state.ae), ('pc', state.pc)):
            grads.update({f'{part}.{n}': p.grad.detach().cpu().clone()
                          for n, p in mod.named_parameters() if p.grad is not None})
        step()

    state.optimizer.step = recording
    try:
        state, comps = trainer.train_step(state, batch)
    finally:
        state.optimizer.step = step
    return state, {k: float(v) for k, v in comps.items()}, grads


def rank_steps(rank, world, init_method, ae_cfg, pc_cfg, batches, model=None):
    """One gloo rank on the CPU, for mesh.spawn: one step from the initial
    state (seed 0, or ``model`` = {'ae', 'pc'} state dicts) on each global
    batch, padded to a multiple of the world, this rank's slice. Returns
    per batch (comps, the {'ae', 'pc'} state dicts after the step, the
    averaged gradients)."""
    mesh = tmesh.init_process_group(rank, world, 'cpu', init_method)
    try:
        trainer = ttrainer.Trainer(ae_cfg, pc_cfg, mesh=mesh)
        out = []
        for batch in batches:
            state = trainer.init_state(0)
            if model is not None:
                state.ae.load_state_dict(model['ae'])
                state.pc.load_state_dict(model['pc'])
            shard = tmesh.shard_batch(tmesh.pad_batch_to_multiple(batch, world), mesh)
            state, comps, grads = recorded_step(trainer, state, shard)
            out.append((comps, {'ae': state.ae.state_dict(), 'pc': state.pc.state_dict()},
                        grads))
        return out
    finally:
        tmesh.destroy_process_group()


def _ranks(world, ae_cfg, pc_cfg, batches, model=None):
    return tmesh.spawn(rank_steps, world, (world, f'tcp://localhost:{tmesh.free_port()}',
                                           ae_cfg, pc_cfg, batches, model))


def _grads_close(got, want, rel):
    """Every gradient leaf within ``rel`` of the leaf's largest entry."""
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=rel * float(g.abs().max()) + 1e-30, err_msg=k)


def test_pad_batch_to_multiple_equals_jax():
    from imgcomp_cvpr_tpu.parallel import mesh as jmesh
    rng = np.random.RandomState(1)
    for n, m in ((5, 8), (5, 5), (5, 2), (9, 8), (1, 3)):
        b = rng.rand(n, 2, 2, 3).astype(np.float32)
        mine, ref = tmesh.pad_batch_to_multiple(b, m), jmesh.pad_batch_to_multiple(b, m)
        assert mine.dtype == ref.dtype and mine.tobytes() == ref.tobytes()
        assert mine.shape[0] % m == 0


@functools.lru_cache(maxsize=None)
def _two_rank_run(minimize_for):
    """One step from the initial state over 2 spawned gloo ranks for each
    batch (8 images, then an odd 5): one spawn serves the cases below."""
    ae_cfg, pc_cfg = tiny_configs(tconfig, distortion_to_minimize=minimize_for)
    batches = [_batch(8, seed=0), _batch(5, seed=1)]
    return batches, _ranks(2, ae_cfg, pc_cfg, batches)


@pytest.mark.parametrize('minimize_for,case', [('mse', 0), ('ms_ssim', 0), ('mse', 1)])
def test_two_gloo_ranks_equal_one_device(minimize_for, case):
    """One step over 2 spawned gloo ranks against the one-device step on the
    same global batch (case 1's odd batch of 5 is padded by repeating its
    last image, on both sides, as the JAX train loop pads for its mesh).
    The averaged gradients that the optimizer steps with equal the
    one-device gradients to 1e-5 of each leaf's largest entry (the loss
    tolerance): a gradient scaled by the world size (summed, not averaged)
    or a regularizer counted on every rank would be off by a whole factor
    in some leaf. Equal losses and comps show the BatchNorm statistics, the
    rate hinge and the MS-SSIM means are taken over the global batch."""
    ae_cfg, pc_cfg = tiny_configs(tconfig, distortion_to_minimize=minimize_for)
    batches, runs = _two_rank_run(minimize_for)
    comps2, model2, grads2 = runs[case]
    t1 = ttrainer.Trainer(ae_cfg, pc_cfg, device='cpu')
    s1, comps1, grads1 = recorded_step(t1, t1.init_state(0),
                                       tmesh.pad_batch_to_multiple(batches[case], 2))
    assert set(comps1) == set(comps2)
    assert comps2['total_loss'] == pytest.approx(comps1['total_loss'], rel=1e-5)
    for k, v in comps1.items():
        assert comps2[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    assert len(grads1) == sum(1 for _ in s1.ae.parameters()) + sum(1 for _ in s1.pc.parameters())
    _grads_close(grads2, grads1, 1e-5)
    for part, mod in (('ae', s1.ae), ('pc', s1.pc)):
        params = dict(mod.named_parameters())
        for name, t in mod.state_dict().items():
            a, b = t.numpy(), model2[part][name].numpy()
            if name in params:
                np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-4, err_msg=name)
                assert np.mean(np.abs(a - b)) < 1e-6, name
            else:   # BatchNorm running statistics
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)


def test_two_rank_step_matches_jax_mesh():
    """The port's 2-rank step and the JAX Trainer over a 2-device mesh, from
    the same weights on the same batch: loss and comps to
    tests/test_torch_training.py's tolerances (rtol 1e-5; comps 2e-5), and
    the port's averaged gradients to the JAX loss's gradient on the sharded
    batch to that file's gradient tolerance (1e-3 of a leaf's largest
    entry)."""
    import jax
    from imgcomp_cvpr_tpu.parallel import mesh as jmesh
    from imgcomp_cvpr_tpu.training import trainer as jtrainer
    from imgcomp_cvpr_tpu.utils import config as jconfig
    from test_torch_training import _batch as tbatch, _jax_init_state, _np_tree
    from test_torch_training import tiny_configs as ttiny
    from imgcomp_cvpr_tpu_torch import weights as tweights
    jae_cfg, jpc_cfg = ttiny(jconfig)
    tae_cfg, tpc_cfg = ttiny(tconfig)
    jstate = _jax_init_state()
    probe = ttrainer.Trainer(tae_cfg, tpc_cfg, num_train_images=64, device='cpu').init_state(0)
    model = {'ae': tweights.ae_state_dict(_np_tree(jstate.params['ae']),
                                          _np_tree(jstate.batch_stats), probe.ae),
             'pc': tweights.pc_state_dict(_np_tree(jstate.params['pc']))}
    batch = tbatch(0)
    mesh = jmesh.make_mesh(2)
    jt = jtrainer.Trainer(jae_cfg, jpc_cfg, num_train_images=64, mesh=mesh)
    state, xb = jmesh.replicate(jstate, mesh), jmesh.shard_batch(batch, mesh)
    with jax.default_matmul_precision('highest'):
        _, jg = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
            state.params, state.batch_stats, xb)
        _, jcomps = jt.train_step(state, xb)
    (comps, _, grads), = _ranks(2, tae_cfg, tpc_cfg, [batch], model)
    assert comps['total_loss'] == pytest.approx(float(jcomps['total_loss']), rel=1e-5)
    for k in jcomps:
        np.testing.assert_allclose(comps[k], float(jcomps[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    ae_g, _ = tweights.ae_trees({n[3:]: g for n, g in grads.items() if n[:3] == 'ae.'},
                                probe.ae)
    mine = {'ae': ae_g, 'pc': tweights.pc_tree(
        {n[3:]: g for n, g in grads.items() if n[:3] == 'pc.'})}
    ref = _np_tree(jg)
    n_leaves = 0
    for part in ('ae', 'pc'):
        a, b = tweights._flatten(ref[part]), tweights._flatten(mine[part])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-3 * np.abs(a[k]).max() + 1e-12,
                                       err_msg=f'{part}/' + '/'.join(k))
            n_leaves += 1
    assert n_leaves == len(grads)


# ---------------------------------------------------------------------------
# Evaluation over a list of devices
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _eval_models():
    from imgcomp_cvpr_tpu_torch.eval import validate as tvalidate
    ae_cfg, pc_cfg = tiny_configs(tconfig)
    state = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu').init_state(3)
    model = {'ae': state.ae.state_dict(), 'pc': state.pc.state_dict()}
    one = tvalidate.EvalModel(ae_cfg, pc_cfg, device='cpu')
    two = tvalidate.EvalModel(ae_cfg, pc_cfg, device=['cpu', 'cpu'])
    one.set_params(model)
    two.set_params(model)
    return one, two


def test_eval_model_on_two_devices_equals_one():
    """5 images over ['cpu', 'cpu'] (padded to a multiple of 2, split, pad
    rows dropped): every per-image output equal to the one-device pass; the
    codec over the same two devices writes the unsplit batch's bytes."""
    from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
    one, two = _eval_models()
    rng = np.random.RandomState(0)
    imgs = [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(5)]
    o1, o2 = one.fetch_many(imgs, pad_batch_to=4), two.fetch_many(imgs, pad_batch_to=4)
    assert len(o1) == len(o2) == 5
    for a, b in zip(o1, o2):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    syms = np.stack([np.transpose(o['sym'], (2, 0, 1)) for o in o1]).astype(np.int8)
    centers = one.ae.encoder.centers.detach().numpy()
    c1 = tcodec.LatentCodec(one.pc, one.pc_config, device='cpu')
    c2 = tcodec.LatentCodec(two.pc, two.pc_config, device=two.devices)
    r1, r2 = c1.encode_batch(syms, centers), c2.encode_batch(syms, centers)
    assert [r.bitstream for r in r1] == [r.bitstream for r in r2]
    np.testing.assert_array_equal(
        c2.decode_batch([r.bitstream for r in r2], centers, device_out=False),
        syms.astype(np.int32))
    assert torch.equal(c2.decode_batch([r.bitstream for r in r2], centers).cpu(),
                       torch.from_numpy(syms.astype(np.int32)))


def test_validate_real_bpp_on_two_devices_equals_one(tmp_path):
    """validate() with --real_bpp through EvalModel(['cpu', 'cpu']): the
    same measures.csv rows as one device, the same stream bytes."""
    from PIL import Image
    from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
    from imgcomp_cvpr_tpu_torch.eval import validate as tvalidate
    from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
    from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir
    one, two = _eval_models()
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(2)
    for i in range(3):
        Image.fromarray((rng.rand(32, 40, 3) * 255).astype(np.uint8)).save(img_dir / f'i{i}.png')
    ae_cfg, pc_cfg = one.ae_config, one.pc_config
    rows, streams = {}, {}
    for name, model in (('one', one), ('two', two)):
        root = tmp_path / name
        log_dir = tlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], str(root))
        tckpt.Saver(tlogdir.ckpt_dir_for_log_dir(log_dir)).save(
            {'model': {'ae': model.ae.state_dict(), 'pc': model.pc.state_dict()}}, 7)
        codec = tcodec.LatentCodec(model.pc, pc_cfg, device=model.devices)
        seen = []
        enc = codec.encode_batch
        codec.encode_batch = lambda s, c: seen.append(enc(s, c)) or seen[-1]
        from imgcomp_cvpr_tpu_torch.data.images_iterator import ImagesIterator
        from imgcomp_cvpr_tpu_torch.eval.val_files import ValidationDirs
        it = ImagesIterator(sorted(glob.glob(str(img_dir / '*.png'))), 'imgs', 0)
        dirs = ValidationDirs(tlogdir.ckpt_dir_for_log_dir(log_dir), str(root), 'imgs', False)
        tvalidate.validate(dirs, it, tvalidate.OutputFlags(real_bpp=True, eval_batch=2),
                           eval_model=model, codec=codec)
        with open(os.path.join(dirs.out_dir, 'measures.csv')) as f:
            rows[name] = sorted(f.read().splitlines())
        streams[name] = sorted(r.bitstream for batch in seen for r in batch)
    assert rows['one'] == rows['two'] and len(rows['one']) == 4
    assert streams['one'] == streams['two'] and len(streams['one']) == 3


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_train_torch_two_cpu_ranks_and_restore_into_one(tmp_path, monkeypatch):
    """train_torch.py --device cpu --num_devices 2 runs 3 steps over two gloo
    ranks (a test evaluation at step 3 too); rank 0 alone writes the log
    dir, and its checkpoint restores into a one-device run, which takes 2
    more steps in the same log dir."""
    import train_torch
    from test_e2e import TINY_AE, TINY_PC
    from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
    from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir
    ae_root, pc_root = tmp_path / 'cfg_ae', tmp_path / 'cfg_pc'
    ae_root.mkdir()
    pc_root.mkdir()
    (ae_root / 'tiny').write_text(TINY_AE)
    (pc_root / 'tiny_pc').write_text(TINY_PC)
    monkeypatch.setenv('CONFIG_BASE_AE', str(ae_root))     # the ranks inherit it
    monkeypatch.setenv('CONFIG_BASE_PC', str(pc_root))
    root = str(tmp_path / 'logs')
    args = ['tiny', 'tiny_pc', '-dtrain', 'synthetic:4', '-dtest', 'synthetic:2',
            '-o', root, '--device', 'cpu', '-ltrain', '1', '-ltest', '3']
    log_dir = train_torch.main(args + ['--max_steps', '3', '--num_devices', '2'])
    assert os.listdir(root) == [os.path.basename(log_dir)]
    ckpt_dir = tlogdir.ckpt_dir_for_log_dir(log_dir)
    assert [i for i, _ in tckpt.all_ckpts_with_iterations(ckpt_dir)] == [3]
    events = {}
    for name in ('train', 'test'):
        with open(os.path.join(log_dir, f'events_{name}.jsonl')) as f:
            events[name] = [json.loads(line) for line in f]
    assert [e['step'] for e in events['train']] == [1, 2, 3]
    assert all(np.isfinite(e['total_loss']) for e in events['train'])
    assert [e['step'] for e in events['test']] == [3]
    # (the one-device run here logs no TensorBoard events: importing
    # torch.utils.tensorboard pulls in TensorFlow, ~16 s, where it is installed)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    log2 = train_torch.main(args + ['--max_steps', '5', '--restore', ckpt_dir,
                                    '--restore_continue'])
    assert log2 == log_dir
    final, itr = tckpt.Saver(ckpt_dir).restore()
    assert itr == 5 and final['step'] == 5
