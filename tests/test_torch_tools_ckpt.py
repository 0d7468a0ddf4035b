"""The port's checkpoint and dataset tools on the CPU, against the JAX
package's tools/: purge_checkpoints (the case of tests/test_eval_aux.py),
ckpt_mapper on the port's torch.save trees and their var_names.json
manifest, gen_natural_set (PNG bytes), make_records (shard bytes, offset
indexes, TF's reader), tf1_import (TF's tensor-bundle format in pure
Python, held to TensorFlow both ways and to the JAX importer tensor for
tensor) and parity_check (PASS / FAIL, and its numbers against the JAX
harness's on the same checkpoint within tests/test_torch_eval.py's bounds:
bpp 1e-4 relative, MS-SSIM 2e-5).

Only the cases that need TensorFlow as the oracle import it
(pytest.importorskip).
"""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imgcomp_cvpr_tpu.models import autoencoder as jae
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.tools import gen_natural_set as jgen
from imgcomp_cvpr_tpu.tools import make_records as jmr
from imgcomp_cvpr_tpu.tools import tf1_import as jtf1
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.data import pipeline as tpipeline
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.tools import ckpt_mapper as tmapper
from imgcomp_cvpr_tpu_torch.tools import gen_natural_set as tgen
from imgcomp_cvpr_tpu_torch.tools import make_records as tmr
from imgcomp_cvpr_tpu_torch.tools import parity_check as tparity
from imgcomp_cvpr_tpu_torch.tools import purge_checkpoints as tpurge
from imgcomp_cvpr_tpu_torch.tools import tf1_import as ttf1
from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(config_lib):
    """cvpr/low at B=1, C=4 with a k=4 context model (tests/test_tf1_import.py)."""
    ae, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    return ae.replace(arch_param_B=1, num_chan_bn=4), pc.replace(arch_param__k=4)


@pytest.fixture(scope='module')
def jax_tiny_trees():
    """JAX-initialised trees of the tiny model (numpy), made once."""
    ae_config, pc_config = _tiny(jconfig)
    ae = jae.get_network_cls(ae_config)(ae_config)
    pc = jpc.ProbClassifier(pc_config, ae_config.num_centers)
    x = jnp.asarray(np.random.RandomState(0).rand(1, 32, 32, 3).astype(np.float32) * 255.0)
    ae_vars = jax.jit(lambda k, x: ae.init(k, x, False))(jax.random.PRNGKey(0), x)
    pc_vars = jax.jit(lambda k: pc.init(k, (1, 4, 4, ae_config.num_chan_bn)))(
        jax.random.PRNGKey(1))
    params = jax.device_get({'ae': ae_vars['params'], 'pc': pc_vars['params']})
    return params, jax.device_get(ae_vars['batch_stats'])


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _same_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg='/'.join(k))


# ---------------- purge_checkpoints ----------------

def test_purge_checkpoints(tmp_path):
    """tests/test_eval_aux.py::test_purge_checkpoints on the port's
    checkpoint files: the second, middle and last of 8 stay."""
    log_dir = tlogdir.create_unique_log_dir(['a'], str(tmp_path / 'logs'))
    ckpt_dir = tlogdir.ckpt_dir_for_log_dir(log_dir)
    os.makedirs(ckpt_dir)
    for itr in range(1, 9):
        open(os.path.join(ckpt_dir, f'ckpt-{itr * 100}'), 'wb').close()
    tpurge.main([str(tmp_path / 'logs'), str(tmp_path / 'archive'), '-v'])
    assert sorted(os.listdir(ckpt_dir)) == ['ckpt-200', 'ckpt-500', 'ckpt-800']
    archived = os.listdir(tmp_path / 'archive' / os.path.basename(log_dir))
    assert sorted(archived) == sorted(f'ckpt-{i}' for i in (100, 300, 400, 600, 700))


def test_iteration_of_checkpoint_and_restore_tree(tmp_path):
    assert tckpt.iteration_of_checkpoint('/x/ckpts/ckpt-9000') == 9000
    with pytest.raises(ValueError):
        tckpt.iteration_of_checkpoint('/x/ckpts/model.pt')
    p = tckpt.Saver(str(tmp_path)).save({'a': {'b': torch.arange(3)}, 'step': 3}, 3)
    tree = tckpt.restore_tree(p)
    assert torch.equal(tree['a']['b'], torch.arange(3)) and tree['step'] == 3


# ---------------- ckpt_mapper ----------------

def test_ckpt_mapper_show_rename_drop(tmp_path, capsys):
    """show lists every leaf; rename writes the renamed tree and a manifest
    of the new names (also where the directory already held a manifest), and
    renaming back restores a TrainState exactly, optimizer moments included
    (their int-keyed state dicts are kept whole); a drop removes leaves."""
    ae_config, pc_config = _tiny(tconfig)
    trainer = ttrainer.Trainer(ae_config.replace(batch_size=2, crop_size=(32, 32)),
                               pc_config, num_train_images=64, device='cpu')
    state = trainer.init_state(0)
    state, _ = trainer.train_step(
        state, (np.random.RandomState(0).rand(2, 32, 32, 3) * 255).astype(np.uint8))
    src = tckpt.Saver(str(tmp_path / 'a' / 'ckpts')).save(state.state_dict(), 1)

    tmapper.main(['show', src])
    shown = capsys.readouterr().out
    assert 'model/ae/encoder.centers  (6,)  torch.float32' in shown
    assert 'model/pc/net.conv_out.weight' in shown and 'step  ()  int' in shown

    out_dir = str(tmp_path / 'b' / 'ckpts')
    tmapper.main(['rename', src, out_dir, '--itr', '7',
                  '--sub', 'model/pc/net.conv_out', 'model/pc/net.conv2'])
    renamed, itr = tckpt.Saver(out_dir).restore()
    assert itr == 7 and 'net.conv2.weight' in renamed['model']['pc']
    assert 'net.conv_out.weight' not in renamed['model']['pc']
    manifest = json.load(open(os.path.join(out_dir, tckpt.VAR_NAMES_FILE)))
    assert manifest == sorted(tckpt.flatten(renamed))
    assert 'model/pc/net.conv2.bias' in manifest

    # back into the same directory, whose manifest holds the renamed names
    tmapper.main(['rename', os.path.join(out_dir, 'ckpt-7'), out_dir, '--itr', '8',
                  '--sub', 'model/pc/net.conv2', 'model/pc/net.conv_out'])
    back, itr = tckpt.Saver(out_dir).restore()
    assert itr == 8
    assert json.load(open(os.path.join(out_dir, tckpt.VAR_NAMES_FILE))) == sorted(
        tckpt.flatten(back))
    state2 = trainer.init_state(1)
    state2.load_state_dict(back)
    want, got = tckpt.flatten(state.state_dict()), tckpt.flatten(state2.state_dict())
    assert set(want) == set(got)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(want[k], got[k]), k
        else:
            assert want[k] == got[k], k

    p = tmapper.create_new_ckpt_with_name_mapping(
        src, str(tmp_path / 'c'), 2, lambda n: None if n.startswith('opt_state') else n)
    dropped = tckpt.restore_tree(p)
    assert set(dropped) == {'model', 'step'}
    assert json.load(open(tmp_path / 'c' / tckpt.VAR_NAMES_FILE)) == sorted(
        tckpt.flatten(dropped))


# ---------------- gen_natural_set ----------------

def test_gen_natural_set_pngs_byte_equal(tmp_path):
    args = ['--n', '3', '--hw', '24x40', '--offset', '10000']
    tgen.main([str(tmp_path / 't')] + args)
    jgen.main([str(tmp_path / 'j')] + args)
    names = sorted(os.listdir(tmp_path / 'j'))
    assert names == ['nat10000.png', 'nat10001.png', 'nat10002.png']
    assert sorted(os.listdir(tmp_path / 't')) == names
    for n in names:
        assert (tmp_path / 't' / n).read_bytes() == (tmp_path / 'j' / n).read_bytes()


# ---------------- make_records ----------------

def _images(src, n=5):
    src.mkdir()
    rng = np.random.RandomState(3)
    for i in range(n):
        img = (rng.rand(20 + 4 * i, 28 + 2 * i, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(src / f'img_{i:03d}.png')
    Image.fromarray((rng.rand(40, 24, 3) * 255).astype(np.uint8)).save(src / 'tall.jpg')
    return str(src)


@pytest.mark.parametrize('resize,workers', [(0, 0), (16, 2)])
def test_make_records_byte_equal(tmp_path, resize, workers):
    """Shards, their .idx.npy indexes and the returned paths equal the JAX
    tool's pure-Python output, with and without the shorter-side resize
    (and through the worker pool); the port's dataset reads them."""
    src = _images(tmp_path / 'src')
    kw = dict(prefix='train', num_per_shard=2, resize=resize)
    got = tmr.make_records(src, str(tmp_path / 't'), workers=workers, **kw)
    want = jmr.make_records(src, str(tmp_path / 'j'), force_py=True, **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3
    for a, b in zip(got, want):
        assert open(a, 'rb').read() == open(b, 'rb').read()
        np.testing.assert_array_equal(np.load(a + '.idx.npy'), np.load(b + '.idx.npy'))
        np.testing.assert_array_equal(np.load(a + '.idx.npy'), tpipeline.tfrecord_index(a))
    ds = tpipeline.get_dataset(os.path.join(str(tmp_path / 't'), '*.tfrecord'))
    assert ds.num_images == 6
    if resize:
        assert min(ds.load(5).shape[:2]) == resize       # tall.jpg, 40x24 -> 26x16
    ds.close()


def test_make_records_cli_and_crc(tmp_path):
    """main() with the JAX tool's flags; the chunk-parallel CRC-32C equals
    the JAX tool's byte loop at lengths around its chunk boundary."""
    src = _images(tmp_path / 'src', n=2)
    tmr.main([src, '-o', str(tmp_path / 'r'), '--prefix', 'val', '--num_per_shard', '10',
              '--workers', '1', '--pure_python'])
    assert sorted(os.listdir(tmp_path / 'r')) == ['val-00000.tfrecord',
                                                  'val-00000.tfrecord.idx.npy']
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 4095, 4096, 4097, 3 * 4096 + 5, 70001):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert tmr._crc32c(data) == jmr._crc32c(data), n
        assert tmr._masked_crc(data) == jmr._masked_crc(data), n
    with pytest.raises(ValueError, match='no images'):
        tmr.make_records(str(tmp_path / 'none*'), str(tmp_path / 'x'))


def test_tf_reads_port_shards(tmp_path):
    tf = pytest.importorskip('tensorflow')
    src = _images(tmp_path / 'src', n=3)
    (shard,) = tmr.make_records(src, str(tmp_path / 'r'), num_per_shard=10)
    got = []
    for raw in tf.data.TFRecordDataset([shard]):
        ex = tf.io.parse_single_example(raw, {
            'image/encoded': tf.io.FixedLenFeature([], tf.string)})
        got.append(np.asarray(Image.open(io.BytesIO(ex['image/encoded'].numpy()))
                              .convert('RGB')))
    paths = tmr.resolve_images(src)
    assert len(got) == 4
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(g, np.asarray(Image.open(p).convert('RGB')))


# ---------------- tf1_import ----------------

@pytest.mark.parametrize('spec', ['cvpr/low', 'cvpr/med', 'cvpr/hi'])
def test_tf1_name_inventory(spec):
    """The port's export of its own modules' weights (weights.ae_trees /
    pc_tree) has the JAX exporter's variable names and shapes for the three
    published configs; tests/test_tf1_import.py::test_tf1_name_inventory
    holds those to the inventory derived from the reference source."""
    ae_config, _ = tconfig.parse_spec(spec, 'ae')
    pc_config, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    ae = tae.CVPRAutoencoder(ae_config, device='cpu')
    pc = tpc.ProbClassifier(pc_config, ae_config.num_centers, device='cpu')
    ae_params, stats = tweights.ae_trees(ae.state_dict(), ae)
    tensors = ttf1.export_tensors({'ae': ae_params, 'pc': tweights.pc_tree(pc.state_dict())},
                                  stats, ae_config)

    jae_config, _ = jconfig.parse_spec(spec, 'ae')
    jae_model = jae.get_network_cls(jae_config)(jae_config)
    jpc_model = jpc.ProbClassifier(jconfig.parse_spec('cvpr/res_shallow', 'pc')[0],
                                   jae_config.num_centers)
    shapes = jax.eval_shape(lambda: {
        'ae': jae_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), False),
        'pc': jpc_model.init(jax.random.PRNGKey(1), (1, 4, 4, jae_config.num_chan_bn))})
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = jtf1.export_tensors({'ae': zeros['ae']['params'], 'pc': zeros['pc']['params']},
                               zeros['ae']['batch_stats'], jae_config)
    assert sorted(tensors) == sorted(want) == sorted(ttf1.expected_names(ae_config))
    for name in want:
        assert tensors[name].shape == want[name].shape, name


def test_tf1_bundle_reads_jax_export_and_tf_reads_port_export(tmp_path, jax_tiny_trees):
    """A checkpoint exported by the JAX tool (tf.raw_ops.SaveV2) imports
    through the port's pure reader to the JAX importer's trees, tensor for
    tensor and exactly; the port's export of the same trees is byte-equal to
    TF's files and tf.train.load_checkpoint reads it back exactly."""
    tf = pytest.importorskip('tensorflow')
    params, batch_stats = jax_tiny_trees
    ae_config, pc_config = _tiny(jconfig)
    jprefix = jtf1.export_tf1_checkpoint(params, batch_stats, ae_config,
                                         str(tmp_path / 'jax' / 'ckpt-1000'))
    want = jtf1.import_tf1_checkpoint(jprefix, ae_config, pc_config)
    got = ttf1.import_tf1_checkpoint(jprefix, *_tiny(tconfig))
    _same_trees(got[0], want[0])
    _same_trees(got[1], want[1])

    tprefix = ttf1.export_tf1_checkpoint(params, batch_stats, ae_config,
                                         str(tmp_path / 'port' / 'ckpt-1000'))
    for ext in ('.index', '.data-00000-of-00001'):
        assert open(tprefix + ext, 'rb').read() == open(jprefix + ext, 'rb').read(), ext
    reader = tf.train.load_checkpoint(tprefix)
    tensors = jtf1.export_tensors(params, batch_stats, ae_config)
    assert sorted(reader.get_variable_to_shape_map()) == sorted(tensors)
    for name, value in tensors.items():
        v = reader.get_tensor(name)
        assert v.dtype == value.dtype, name
        np.testing.assert_array_equal(v, value, err_msg=name)


def test_tf1_roundtrip_into_port_modules(tmp_path, jax_tiny_trees):
    """Export, import with the pure reader and load through weights.*:
    the port's modules equal those loaded from the trees directly. The
    reader refuses a corrupted tensor and a file that is not a checkpoint;
    the writer refuses an index larger than one data block."""
    params, batch_stats = jax_tiny_trees
    ae_config, pc_config = _tiny(tconfig)
    prefix = ttf1.export_tf1_checkpoint(params, batch_stats, ae_config,
                                        str(tmp_path / 'ckpt-1'))
    p2, b2 = ttf1.import_tf1_checkpoint(prefix, ae_config, pc_config)
    ae = tae.CVPRAutoencoder(ae_config, device='cpu')
    sd_direct = tweights.ae_state_dict(params['ae'], batch_stats, ae)
    sd_import = tweights.ae_state_dict(p2['ae'], b2, ae)
    pc_direct = tweights.pc_state_dict(params['pc'])
    pc_import = tweights.pc_state_dict(p2['pc'])
    for a, b in ((sd_direct, sd_import), (pc_direct, pc_import)):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    ae.load_state_dict(sd_import, strict=True)

    data = prefix + '.data-00000-of-00001'
    raw = bytearray(open(data, 'rb').read())
    raw[len(raw) // 2] ^= 0xFF
    open(data, 'wb').write(bytes(raw))
    reader = ttf1.BundleReader(prefix)
    bad = [n for n in reader.get_variable_to_shape_map()
           if not _reads(reader, n)]
    assert len(bad) == 1
    open(str(tmp_path / 'junk.index'), 'wb').write(b'\0' * 100)
    with pytest.raises(ValueError, match='magic'):
        ttf1.BundleReader(str(tmp_path / 'junk'))
    many = {f'scope_{i:05d}/' + 'w' * 40: np.zeros(1, np.float32) for i in range(5000)}
    with pytest.raises(ValueError, match='more than one data block'):
        ttf1.write_bundle(many, str(tmp_path / 'many' / 'ckpt-1'))


def _reads(reader, name):
    try:
        reader.get_tensor(name)
        return True
    except ValueError:
        return False


# ---------------- parity_check ----------------

@pytest.fixture
def parity_setup(tmp_path, jax_tiny_trees, monkeypatch):
    """The tiny model exported by the port's pure writer under a job-id-like
    path, three 32x32 PNGs, and parse_spec of both packages returning the
    tiny configs (tests/test_tf1_import.py's end-to-end case)."""
    params, batch_stats = jax_tiny_trees
    prefix = ttf1.export_tf1_checkpoint(params, batch_stats, _tiny(tconfig)[0],
                                        str(tmp_path / '0515_9999' / 'ckpt-1'))
    img_dir = tmp_path / 'imgs'
    img_dir.mkdir()
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
            img_dir / f'im{i}.png')
    for mod in (tconfig, jconfig):
        tiny = _tiny(mod)
        monkeypatch.setattr(mod, 'parse_spec',
                            lambda spec, kind, t=tiny: (t[0] if kind == 'ae' else t[1], None))
    return prefix, str(img_dir)


def test_parity_check_pass_and_fail(parity_setup, capsys):
    prefix, img_dir = parity_setup
    ok, bpp, msssim = tparity.run_parity(prefix, 'tiny', 'tiny', img_dir, device='cpu')
    assert ok and np.isfinite(bpp) and 0 < msssim <= 1
    assert tparity.main([prefix, '--images', img_dir, '--ae', 'tiny', '--pc', 'tiny',
                         '--expected_bpp', repr(bpp), '--expected_msssim', repr(msssim),
                         '--device', 'cpu']) == 0
    assert tparity.main([prefix, '--images', img_dir, '--ae', 'tiny', '--pc', 'tiny',
                         '--expected_bpp', repr(bpp * 1.2), '--expected_msssim',
                         repr(msssim), '--device', 'cpu']) == 1
    assert 'FAIL' in capsys.readouterr().out
    # Data-parallel over two CPU copies of the model: the same numbers.
    assert tparity.run_parity(prefix, 'tiny', 'tiny', img_dir, num_devices=2,
                              device='cpu') == (ok, bpp, msssim)
    assert tparity.main([prefix, '--images', img_dir, '--ae', 'tiny', '--pc', 'tiny',
                         '--expected_bpp', repr(bpp), '--expected_msssim', repr(msssim),
                         '--num_devices', '2', '--device', 'cpu']) == 0


def test_parity_check_matches_jax_harness(parity_setup):
    """The same checkpoint through the JAX harness (TF's reader): bpp and
    MS-SSIM within tests/test_torch_eval.py's bounds."""
    pytest.importorskip('tensorflow')
    from imgcomp_cvpr_tpu.tools import parity_check as jparity
    prefix, img_dir = parity_setup
    _, bpp, msssim = tparity.run_parity(prefix, 'tiny', 'tiny', img_dir, device='cpu')
    _, jbpp, jmsssim = jparity.run_parity(prefix, 'tiny', 'tiny', img_dir)
    assert abs(bpp - jbpp) <= 1e-4 * jbpp
    assert abs(msssim - jmsssim) <= 2e-5


def test_parity_manifest_only(tmp_path, capsys):
    """--manifest-only (tests/test_tf1_import.py::test_parity_manifest_only):
    a complete name list passes, also found by job id; a missing or an
    unmapped model variable fails."""
    ae_config, _ = tconfig.parse_spec('cvpr/low', 'ae')
    names = [n + ':0' for n in ttf1.expected_names(ae_config)]
    names += ['autoencoder/encoder/h1/weights/Adam:0', 'beta1_power:0', 'global_step:0']
    job = tmp_path / '0515_1103'
    job.mkdir()
    (job / 'var_names.pkl').write_bytes(pickle.dumps(names))
    assert tparity.main(['--manifest-only', str(job / 'var_names.pkl')]) == 0
    assert 'OK' in capsys.readouterr().out
    specs = ['--ae', 'cvpr/low', '--pc', 'cvpr/res_shallow']
    missing = tmp_path / 'missing.txt'
    missing.write_text('\n'.join(n for n in names if 'conv0_mask/weights' not in n))
    assert tparity.main(['--manifest-only', str(missing)] + specs) == 1
    assert 'MISSING' in capsys.readouterr().out
    extra = tmp_path / 'extra.pkl'
    extra.write_bytes(pickle.dumps(names + ['autoencoder/mystery:0']))
    assert tparity.main(['--manifest-only', str(extra)] + specs) == 1
    assert 'UNMAPPED' in capsys.readouterr().out
