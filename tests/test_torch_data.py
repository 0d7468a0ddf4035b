"""The port's data modules against the JAX package's on identical inputs:
natural images byte for byte, padding and its geometry, validation-image
specs, every get_dataset kind (names, paths, order and decoded images), and
TFRecord shards written by the JAX package's tools/make_records.py.
"""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from imgcomp_cvpr_tpu.data import images_iterator as jii
from imgcomp_cvpr_tpu.data import natural as jnatural
from imgcomp_cvpr_tpu.data import pipeline as jpipeline
from imgcomp_cvpr_tpu.data import val_images as jval_images
from imgcomp_cvpr_tpu.tools import make_records as jmake_records
from imgcomp_cvpr_tpu.utils import constants as jconstants
from imgcomp_cvpr_tpu_torch.data import images_iterator as tii
from imgcomp_cvpr_tpu_torch.data import natural as tnatural
from imgcomp_cvpr_tpu_torch.data import pipeline as tpipeline
from imgcomp_cvpr_tpu_torch.data import val_images as tval_images
from imgcomp_cvpr_tpu_torch.utils import constants as tconstants


def _rgb(seed, h, w, c=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(h, w, c) * 255).astype(np.uint8)


@pytest.mark.parametrize('idx,h,w', [(0, 32, 48), (10005, 64, 96)])
def test_natural_image_is_byte_equal(idx, h, w):
    a = tnatural.natural_image(idx, h, w)
    assert a.shape == (h, w, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, jnatural.natural_image(idx, h, w))


@pytest.mark.parametrize('kind', ['rgb', 'grey', 'rgba'])
def test_add_padding_matches_jax(kind):
    img = {'rgb': _rgb(1, 50, 61), 'grey': _rgb(2, 50, 61, 1)[..., 0],
           'rgba': _rgb(3, 50, 61, 4)}[kind]
    (pa, undo_a), (pb, undo_b) = tii.add_padding(img, 8), jii.add_padding(img, 8)
    assert pa.shape == (56, 64, 3)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(undo_a(pa), undo_b(pb))
    assert undo_a(pa).shape == (50, 61, 3)
    # centred: 3 rows above, 3 below, 1 column left, 2 right, all zeros
    assert not pa[:3].any() and not pa[-3:].any() and not pa[:, :1].any()
    # already a multiple: returned as is
    same, undo = tii.add_padding(_rgb(4, 16, 24), 8)
    np.testing.assert_array_equal(undo(same), _rgb(4, 16, 24))


def test_iter_padded_matches_jax(tmp_path):
    """RGB 50x61, grey 30x41 and RGBA 17x23 PNGs: the same padded arrays,
    names and pad geometry (hp_lo, wp_lo, oh, ow), cached or not."""
    specs = [('a.png', _rgb(5, 50, 61), 'RGB'), ('b.png', _rgb(6, 30, 41, 1)[..., 0], 'L'),
             ('c.png', _rgb(7, 17, 23, 4), 'RGBA')]
    paths = []
    for name, arr, mode in specs:
        Image.fromarray(arr, mode).save(tmp_path / name)
        paths.append(str(tmp_path / name))
    for cache_mb in (500, 0):
        got = list(tii.ImagesIterator(paths, 'x', cache_mb).iter_padded(pad=8))
        want = list(jii.ImagesIterator(paths, 'x', cache_mb).iter_padded(pad=8))
        assert [g[0] for g in got] == ['a.png', 'b.png', 'c.png']
        assert [g[2] for g in got] == [w[2] for w in want] == [
            (3, 1, 50, 61), (1, 3, 30, 41), (3, 0, 17, 23)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[1], w[1])
    it = tii.ImagesIterator(paths, 'x')
    assert [n for n, _ in it.iter_imgs(pad=8)] == ['a.png', 'b.png', 'c.png']
    with pytest.raises(ValueError):
        tii.ImagesIterator([], 'x')


@pytest.fixture
def png_tree(tmp_path):
    """Two PNGs at the top of 'imgs/' and one in a sub-directory."""
    root = tmp_path / 'imgs'
    (root / 'sub').mkdir(parents=True)
    for i, rel in enumerate(['b.png', 'a.png', 'sub/c.png']):
        Image.fromarray(_rgb(10 + i, 24, 20)).save(root / rel)
    return root


@pytest.mark.parametrize('kind', ['dir', 'glob', 'alias'])
def test_get_image_paths_matches_jax(kind, png_tree, tmp_path, monkeypatch):
    if kind == 'alias':
        kodak = tmp_path / 'valroot' / 'kodak'
        kodak.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(_rgb(20 + i, 8, 8)).save(kodak / f'k{i}.png')
        monkeypatch.setattr(tconstants, 'VALIDATION_DATASETS_ROOT', str(tmp_path / 'valroot'))
        monkeypatch.setattr(jconstants, 'VALIDATION_DATASETS_ROOT', str(tmp_path / 'valroot'))
    spec = {'dir': str(png_tree) + os.sep, 'glob': str(png_tree / '*' / '*.png'),
            'alias': 'kodak'}[kind]
    got = tval_images.get_image_paths(spec)
    assert got == jval_images.get_image_paths(spec)
    assert got[1] == {'dir': 'imgs', 'glob': 'imgs', 'alias': 'kodak'}[kind]
    assert len(got[0]) == {'dir': 2, 'glob': 1, 'alias': 2}[kind]
    with pytest.raises(ValueError):
        tval_images.get_image_paths(str(tmp_path / 'nothing'))


def _same_dataset(a, b, name):
    assert type(a).__name__ == type(b).__name__
    assert a.name == b.name == name
    assert a.paths == b.paths and a.num_images == b.num_images
    for i in range(a.num_images):
        np.testing.assert_array_equal(a.load(i), b.load(i))


@pytest.mark.parametrize('kind', ['natural', 'dir', 'txt', 'pkl', 'glob'])
def test_get_dataset_matches_jax(kind, png_tree, tmp_path):
    files = sorted(str(p) for p in png_tree.rglob('*.png'))
    if kind == 'txt':
        (tmp_path / 'list.txt').write_text('\n'.join(files) + '\n\n')
    if kind == 'pkl':
        with open(tmp_path / 'list.pkl', 'wb') as f:
            pickle.dump(files, f)
    spec, name = {'natural': ('natural:3:48x64', 'natural'), 'dir': (str(png_tree), 'imgs'),
                  'txt': (str(tmp_path / 'list.txt'), 'list.txt'),
                  'pkl': (str(tmp_path / 'list.pkl'), 'list.pkl'),
                  'glob': (str(png_tree / '*.png'), 'glob')}[kind]
    a, b = tpipeline.get_dataset(spec), jpipeline.get_dataset(spec)
    _same_dataset(a, b, name)
    assert a.num_images == {'natural': 3, 'glob': 2}.get(kind, 3)
    if kind == 'natural':
        assert a.load(2).shape == (48, 64, 3)


def _shards(tmp_path, n=5, per_shard=2):
    src = tmp_path / 'src'
    src.mkdir()
    for i in range(n):
        Image.fromarray(_rgb(30 + i, 20, 28)).save(src / f'img_{i:03d}.png')
    return jmake_records.make_records(str(src), str(tmp_path / 'records'), prefix='train',
                                      num_per_shard=per_shard, force_py=True)


def test_records_dataset_reads_make_records_shards(tmp_path):
    """Shards of the JAX package's pure-Python writer: both RecordsDatasets
    give the same images in the same order; the port's own index scan gives
    the JAX package's offsets; the shard-aware shuffle and a shuffled
    pipeline's batches are the JAX package's."""
    shards = _shards(tmp_path)
    want_offsets = [np.load(s + '.idx.npy') for s in shards]
    for s in shards:
        os.remove(s + '.idx.npy')       # the port builds its own index
    spec = str(tmp_path / 'records' / '*.tfrecord')
    a = tpipeline.get_dataset(spec)
    for s, want in zip(shards, want_offsets):
        np.testing.assert_array_equal(np.load(s + '.idx.npy'), want)
    b = jpipeline.get_dataset(spec)
    assert isinstance(a, tpipeline.RecordsDataset) and a.num_images == 5
    _same_dataset(a, b, '*.tfrecord')
    np.testing.assert_array_equal(a.load(3), _rgb(33, 20, 28))
    np.testing.assert_array_equal(a.shuffled_order(np.random.RandomState(4)),
                                  b.shuffled_order(np.random.RandomState(4)))
    kw = dict(crop_size=(16, 16), batch_size=3, num_preprocess_threads=1, seed=2)
    pa = tpipeline.InputPipeline(a, **kw).start()
    pb = jpipeline.InputPipeline(b, **kw).start()
    try:
        for _ in range(3):
            np.testing.assert_array_equal(pa.get_batch(), pb.get_batch())
    finally:
        pa.stop()
        pb.stop()
    a.close()


def test_known_records_names_resolve_under_records_root(tmp_path, monkeypatch):
    """'imgnet_train' resolves to the train-*.tfrecord shards under
    $RECORDS_ROOT, and raises the JAX package's ValueError where there are
    none ('imgnet_test' here)."""
    _shards(tmp_path)
    for mod in (tconstants, jconstants):
        monkeypatch.setattr(mod, 'RECORDS_ROOT', str(tmp_path / 'records'))
    a, b = tpipeline.get_dataset('imgnet_train'), jpipeline.get_dataset('imgnet_train')
    _same_dataset(a, b, 'imgnet_train')
    for get in (tpipeline.get_dataset, jpipeline.get_dataset):
        with pytest.raises(ValueError, match='no TFRecord shards matching val'):
            get('imgnet_test')


def test_example_bytes_feature_key_and_fallback():
    ex = jmake_records.serialize_example(b'payload', key='image/other')
    assert tpipeline.example_bytes_feature(ex, 'image/other') == b'payload'
    assert tpipeline.example_bytes_feature(ex, 'image/encoded') == b'payload'  # fallback
    with pytest.raises(ValueError):
        tpipeline.example_bytes_feature(b'', 'image/encoded')
