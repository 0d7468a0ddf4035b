"""The port imports neither JAX nor the JAX package.

A subprocess installs a meta-path finder that refuses ``jax``, ``jaxlib``
and ``imgcomp_cvpr_tpu`` (not ``imgcomp_cvpr_tpu_torch``), then imports every
module of the port (the training, data and eval modules included),
``chip_smoke``, ``train_torch``, ``val_torch``, ``bench_torch`` and
``graft_entry_torch``; any such
import raises there. ``flax``, ``optax``,
``orbax`` and ``tensorflow`` are refused too (the tools read and write
TFRecord shards and TF checkpoints in pure Python).
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = textwrap.dedent('''
    import importlib, pkgutil, sys

    BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'imgcomp_cvpr_tpu', 'tensorflow')

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            top = name.split('.')[0]
            if top in BANNED:
                raise ImportError('the port must not import ' + name)
            return None

    for mod in list(sys.modules):
        if mod.split('.')[0] in BANNED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Refuse())
    import imgcomp_cvpr_tpu_torch as pkg
    mods = ['chip_smoke', 'train_torch', 'val_torch', 'bench_torch', 'graft_entry_torch',
            'imgcomp_cvpr_tpu_torch']
    mods += [m.name for m in pkgutil.walk_packages(pkg.__path__, 'imgcomp_cvpr_tpu_torch.')]
    for m in mods:
        importlib.import_module(m)
    bad = sorted(m for m in sys.modules if m.split('.')[0] in BANNED)
    assert not bad, bad
    for m in ('training.trainer', 'training.train_loop', 'training.checkpoint',
              'training.optimizers', 'training.losses', 'training.distortions',
              'data.pipeline', 'ops.msssim', 'ops.metrics', 'ops.bits', 'utils.logger',
              'utils.logdir', 'coding.bpp', 'utils.constants', 'utils.registry',
              'data.natural', 'data.images_iterator', 'data.val_images', 'ops.msssim_np',
              'eval.validate', 'eval.val_files', 'eval.compare_imgs', 'eval.other_codecs',
              'eval.codec_distance', 'eval.plotter', 'tools.codec_cli', 'tools.profile_codec',
              'tools.ab_streams', 'tools.parity_check', 'tools.tf1_import', 'tools.ckpt_mapper',
              'tools.make_records', 'tools.gen_natural_set', 'tools.purge_checkpoints',
              'parallel.mesh'):
        assert 'imgcomp_cvpr_tpu_torch.' + m in mods, m
    print(len(mods), 'modules')
''')


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, '-c', GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n = int(out.stdout.split()[-2])
    assert n >= 69, out.stdout
