"""The port's codec tools on the CPU, against the JAX package's tools/:
codec_cli (.icz files: the header, the symbols, decompress against the
port's own AE decode and against the JAX tool's decompress of its own file,
the model tag, refusal of a JAX-written file, main() in its three modes,
--npz and --log_dir), profile_codec (the report's keys; decoded symbols
equal to the encoded ones) and ab_streams (dump / compare / cross, a
corrupted dump, bsub, and `ab` in a throwaway git repository holding a copy
of the port).

Tolerances (the f32 AE bounds of tests/test_torch_models.py and
tests/test_torch_eval.py): symbol flips at most 1e-3 of the symbols;
pixels of the same symbols' decode off by at most 1 on at most 1e-3 of
them. Measured here on the trained model at 64x96 and 61x93: no flip, no
pixel off. The JAX tool codes with its own impl (ring on the CPU), so its
container bytes differ from the port's; the .icz header fields before the
container length are equal.
"""

import os
import pickle
import shutil
import struct
import subprocess

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from imgcomp_cvpr_tpu.tools import codec_cli as jcli
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu.utils import constants as jconstants
from imgcomp_cvpr_tpu_torch.data import natural as tnatural
from imgcomp_cvpr_tpu_torch.data.images_iterator import add_padding
from imgcomp_cvpr_tpu_torch.tools import ab_streams as tab
from imgcomp_cvpr_tpu_torch.tools import codec_cli as tcli
from imgcomp_cvpr_tpu_torch.tools import profile_codec as tprofile
from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir

from test_codec_cli import TINY_AE, TINY_PC, _save_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, 'assets', 'demo_trained_low_9000.npz')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crop(x, oh, ow):
    hp_lo, wp_lo = (x.shape[0] - oh) // 2, (x.shape[1] - ow) // 2
    return x[hp_lo:hp_lo + oh, wp_lo:wp_lo + ow]


def _check_against_jax(tmodel, jmodel, img):
    """The port's file and image against the JAX tool's on one image."""
    oh, ow = img.shape[:2]
    tblob, jblob = tmodel.compress(img), jmodel.compress(img)
    assert tblob[:12] == jblob[:12]                    # magic, h, w, model tag
    assert struct.unpack('<I', tblob[12:16])[0] == len(tblob) - 16
    padded, _ = add_padding(img, 8)
    tsyms = tmodel._enc(padded[None]).numpy()
    jsyms = np.asarray(jmodel._enc(jmodel.ae_vars, padded[None]))
    assert tsyms.dtype == jsyms.dtype == np.int8
    assert int((tsyms != jsyms).sum()) <= 1e-3 * jsyms.size
    out = tmodel.decompress(tblob)
    assert out.shape == img.shape and out.dtype == np.uint8
    own = _crop(tmodel._dec(torch.from_numpy(tsyms))[0].numpy(), oh, ow)
    np.testing.assert_array_equal(out, own)
    jout = jmodel.decompress(jblob)
    diff = np.abs(out.astype(np.int32) - jout.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    return tblob, jblob


@pytest.fixture(scope='module')
def trained_models():
    return (tcli.load_model(npz=ASSET, device='cpu'), jcli.load_model(npz=ASSET))


@pytest.mark.parametrize('hw', [(64, 96), (61, 93)])
def test_codec_cli_trained_matches_jax(trained_models, hw):
    """The trained npz (ae cvpr/low + pc cvpr/res_shallow): header fields,
    symbols, the port's decompress against its own AE decode (exact) and
    against the JAX tool's decompress of its own file; 61x93 is padded to
    64x96 and cropped back."""
    tmodel, jmodel = trained_models
    _, jblob = _check_against_jax(tmodel, jmodel, tnatural.natural_image(10000, *hw))
    if hw == (64, 96):
        # a file of the JAX tool carries its impl id (0-4): refused, not garbled
        with pytest.raises(ValueError, match='not decodable by the port'):
            tmodel.decompress(jblob)


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    """tests/test_codec_cli.py's tiny configs (C=4), JAX-initialised, and the
    port's model carrying the same weights (made once; the config roots stay
    set for the module's tests)."""
    from imgcomp_cvpr_tpu.models import autoencoder as jae
    from imgcomp_cvpr_tpu.models import probclass as jpc
    from imgcomp_cvpr_tpu_torch.utils import constants as tconstants
    tmp_path = tmp_path_factory.mktemp('tiny')
    ae_root, pc_root = tmp_path / 'cfg_ae', tmp_path / 'cfg_pc'
    ae_root.mkdir()
    pc_root.mkdir()
    (ae_root / 'tiny').write_text(TINY_AE)
    (pc_root / 'tiny_pc').write_text(TINY_PC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('CONFIG_BASE_AE', str(ae_root))
        mp.setenv('CONFIG_BASE_PC', str(pc_root))
        for mod in (jconstants, tconstants):
            mp.setattr(mod, 'CONFIG_BASE_AE', str(ae_root))
            mp.setattr(mod, 'CONFIG_BASE_PC', str(pc_root))
        ae_config, _ = jconfig.parse_spec('tiny', 'ae')
        pc_config, _ = jconfig.parse_spec('tiny_pc', 'pc')
        ae = jae.get_network_cls(ae_config)(ae_config)
        pc = jpc.ProbClassifier(pc_config, ae_config.num_centers)
        vars_ae = jax.jit(lambda k: ae.init(k, np.zeros((1, 32, 32, 3), np.float32), False))(
            jax.random.PRNGKey(0))
        vars_pc = jax.jit(lambda k: pc.init(k, (1, 4, 4, 4)))(jax.random.PRNGKey(1))
        params = jax.device_get({'ae': vars_ae['params'], 'pc': vars_pc['params']})
        stats = jax.device_get(vars_ae['batch_stats'])
        npz = tmp_path / 'model.npz'
        _save_npz(npz, params, stats)
        jmodel = jcli.CodecModel(ae_config, pc_config, params, stats)
        tmodel = tcli.load_model(npz=str(npz), ae_spec='tiny', pc_spec='tiny_pc',
                                 device='cpu')
        yield tmodel, jmodel, str(npz)


def test_codec_cli_tiny_matches_jax_and_rejects(tiny):
    """tests/test_codec_cli.py's cases on the port: a 30x38 image against
    the JAX tool; a tampered model tag and a JAX-written file are refused."""
    tmodel, jmodel, _ = tiny
    rng = np.random.RandomState(0)
    img = (rng.rand(30, 38, 3) * 255).astype(np.uint8)
    tblob, jblob = _check_against_jax(tmodel, jmodel, img)
    bad = bytearray(tblob)
    bad[8:12] = struct.pack('<I', struct.unpack('<I', bad[8:12])[0] ^ 0xDEAD)
    with pytest.raises(ValueError, match='model tag mismatch'):
        tmodel.decompress(bytes(bad))
    with pytest.raises(ValueError, match='not decodable by the port'):
        tmodel.decompress(jblob)
    with pytest.raises(ValueError, match='not an ICZ1 file'):
        tmodel.decompress(b'PNG0' + tblob[4:])
    with pytest.raises(ValueError, match='truncated'):
        tmodel.decompress(tblob[:-1])


def test_codec_cli_main_modes_and_log_dir(tiny, tmp_path, capsys):
    """main() in compress / decompress / roundtrip with --npz; a log dir of
    the port's checkpoints (--log_dir) codes like the npz."""
    tmodel, _, npz = tiny
    img = (np.random.RandomState(2).rand(24, 24, 3) * 255).astype(np.uint8)
    src, icz, dst = (str(tmp_path / n) for n in ('in.png', 'out.icz', 'out.png'))
    Image.fromarray(img).save(src)
    common = ['--npz', npz, '--ae_config', 'tiny', '--pc_config', 'tiny_pc', '--device', 'cpu']
    tcli.main(['compress', src, '-o', icz] + common)
    tcli.main(['decompress', icz, '-o', dst] + common)
    out = np.asarray(Image.open(dst))
    np.testing.assert_array_equal(out, tmodel.decompress(tmodel.compress(img)))
    assert open(icz, 'rb').read() == tmodel.compress(img)
    tcli.main(['roundtrip', src, '-o', str(tmp_path / 'rt.icz')] + common)
    printed = capsys.readouterr().out
    assert 'bpp (file, incl. header)' in printed and '24x24' in printed
    assert 'CRC-verified' in printed and 'PSNR' in printed

    log_dir = tlogdir.create_unique_log_dir(['tiny', 'tiny_pc'], str(tmp_path / 'logs'))
    tckpt.Saver(tlogdir.ckpt_dir_for_log_dir(log_dir)).save(
        {'model': {'ae': tmodel.ae.state_dict(), 'pc': tmodel.pc.state_dict()}, 'step': 5}, 5)
    lmodel = tcli.load_model(log_dir=log_dir, device='cpu')
    blob = lmodel.compress(img)
    assert blob == tmodel.compress(img)
    np.testing.assert_array_equal(lmodel.decompress(blob), out)
    with pytest.raises(ValueError, match='--log_dir or --npz'):
        tcli.load_model(device='cpu')


def test_profile_codec_report():
    """B=2 at 16x24 on the CPU: every key of the JAX tool's report (the
    decode is asserted equal to the encode inside profile)."""
    r = tprofile.profile(batch=2, h=16, w=24, iters=1, device='cpu')
    for k in ('ae_encode_s', 'cdf_scan_s', 'reverse_rans_scan_s', 'encode_batch_total_s',
              'decode_batch_total_s', 'ae_decode_s', 'end_to_end_mp_per_s',
              'steps_per_scan', 'lanes', 'rans_lanes', 'device', 'launches'):
        assert k in r, k
    assert r['device'] == 'cpu' and r['rans_lanes'] == 32 and r['lanes'] % 128 == 0
    assert r['steps_per_scan'] > 0 and r['decode_batch_total_s'] > 0
    assert r['launches'] and not any(r['launches'].values())   # plain versions only


# ---------------- ab_streams ----------------

_SMALL = ['--shape', '3', '4', '5', '--batch', '2']


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('impl,k', [('cuda', '3'), ('cuda_planar', '5')])
def test_ab_streams_dump_compare_cross(tmp_path, capsys, impl, k, batch):
    small = ['--shape', '3', '4', '5', '--batch', str(batch), '--impl', impl, '--k', k]
    a, b = str(tmp_path / 'a.pkl'), str(tmp_path / 'b.pkl')
    for out in (a, b):
        assert tab.main(['--cpu', 'dump'] + small + ['--out', out]) == 0
    assert tab.main(['--cpu', 'compare', a, b]) == 0
    assert tab.main(['--cpu', 'compare', a, b, '--payload-only']) == 0
    assert tab.main(['--cpu', 'cross', a]) == 0
    d = pickle.load(open(a, 'rb'))
    assert d['impl'] == impl and sorted(d['cases']) == [1]
    assert d['kernel_libs_loaded'] == {} and 'rans_reverse' in d['kernel_libs']
    s = bytearray(d['cases'][1]['streams'][batch - 1])
    s[-1] ^= 0x01
    d['cases'][1]['streams'][batch - 1] = bytes(s)
    pickle.dump(d, open(b, 'wb'))
    capsys.readouterr()
    assert tab.main(['--cpu', 'compare', a, b]) == 1
    assert f'STREAM MISMATCH bsub=1 image={batch - 1}' in capsys.readouterr().out
    with pytest.raises(ValueError, match='bsub 1 only'):
        tab.main(['--cpu', 'dump'] + small + ['--bsubs', '1', '2', '--out', a])


def test_ab_streams_takes_only_the_served_codecs(capsys):
    """--impl is cuda or cuda_planar: the retired scan codecs' names are
    refused as argparse refuses any unknown choice."""
    with pytest.raises(SystemExit):
        tab.main(['--cpu', 'dump'] + _SMALL + ['--impl', 'direct', '--out', 'unused.pkl'])
    assert "invalid choice: 'direct'" in capsys.readouterr().err


@pytest.mark.parametrize('impl,k', [('cuda', '3'), ('cuda_planar', '5')])
def test_ab_streams_ab_in_a_throwaway_repo(tmp_path, monkeypatch, capsys, impl, k):
    """`ab` in a git repository made here from a copy of the port: HEAD's
    worktree and the working tree each run their own package; a kernel
    source edited in the working tree shows as differing library hashes,
    while the streams (plain versions on the CPU) stay byte-identical."""
    repo = tmp_path / 'repo'
    shutil.copytree(os.path.join(ROOT, 'imgcomp_cvpr_tpu_torch'),
                    repo / 'imgcomp_cvpr_tpu_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    git = ['git', '-c', 'user.name=t', '-c', 'user.email=t@t', '-c', 'init.defaultBranch=m']
    for cmd in (['init', '-q'], ['add', '-A'], ['commit', '-q', '-m', 'head']):
        subprocess.check_call(git + cmd, cwd=repo)
    with open(repo / 'imgcomp_cvpr_tpu_torch' / 'csrc' / 'rans_reverse.cu', 'a') as f:
        f.write('\n// edited in the working tree\n')
    monkeypatch.chdir(repo)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    rc = tab.main(['--cpu', 'ab'] + _SMALL + ['--impl', impl, '--k', k,
                                             '--worktree', str(tmp_path / 'wt')])
    printed = capsys.readouterr().out
    assert rc == 0, printed
    assert 'compare: streams byte-identical' in printed and 'ab: PASS' in printed
    assert "kernel sources differ" in printed and 'rans_reverse-' in printed
    assert subprocess.check_output(['git', 'status', '--porcelain'],
                                   cwd=tmp_path / 'wt', text=True) == ''
