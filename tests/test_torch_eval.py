"""The port's validation path and eval tools on the CPU, against the JAX
package: the baseline-codec tools (tests/test_eval_aux.py's cases, with the
port's results held equal to the JAX modules' where they are deterministic),
EvalModel.fetch_many and a whole validate() with the trained weights, the
unpadded-frame metrics and shape buckets (tests/test_unpadded_eval.py's
cases), the real-bpp triangle through the port's LatentCodec at K=3 and K=5
(tests/test_real_bpp.py), val_torch.py, and the training loop's d_BPG
monitor, image dumps and run registry.

Tolerances of the port against JAX on the trained model (measured on the
CPU: bpp 1e-5 relative, MS-SSIM 3e-6, PSNR 2e-6 dB, no symbol flips, equal
output images): bpp 1e-4 relative, MS-SSIM 2e-5, PSNR 1e-4 dB, symbol flips
at most 1e-3 of the symbols (the f32 AE bound of tests/test_torch_models.py),
output pixels off by at most 1 on at most 1e-3 of them.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from imgcomp_cvpr_tpu.data import images_iterator as jii
from imgcomp_cvpr_tpu.eval import codec_distance as jcd
from imgcomp_cvpr_tpu.eval import compare_imgs as jcompare
from imgcomp_cvpr_tpu.eval import other_codecs as jother
from imgcomp_cvpr_tpu.eval import val_files as jval_files
from imgcomp_cvpr_tpu.eval import validate as jvalidate
from imgcomp_cvpr_tpu.training import checkpoint as jckpt
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu.utils import constants as jconstants
from imgcomp_cvpr_tpu.utils import logdir as jlogdir
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as tck
from imgcomp_cvpr_tpu_torch.data import images_iterator as tii
from imgcomp_cvpr_tpu_torch.eval import codec_distance as tcd
from imgcomp_cvpr_tpu_torch.eval import compare_imgs as tcompare
from imgcomp_cvpr_tpu_torch.eval import other_codecs as tother
from imgcomp_cvpr_tpu_torch.eval import plotter as tplotter
from imgcomp_cvpr_tpu_torch.eval import val_files as tval_files
from imgcomp_cvpr_tpu_torch.eval import validate as tvalidate
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.ops import bits as tbits
from imgcomp_cvpr_tpu_torch.ops import metrics as tmetrics
from imgcomp_cvpr_tpu_torch.training import checkpoint as tckpt
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from imgcomp_cvpr_tpu_torch.utils import constants as tconstants
from imgcomp_cvpr_tpu_torch.utils import logdir as tlogdir
from imgcomp_cvpr_tpu_torch.utils import registry as tregistry

from test_e2e import TINY_AE, TINY_PC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(ROOT, 'assets', 'demo_trained_low_9000.npz')
NATKODAK = os.path.join(ROOT, 'work_rd', 'natkodak24')

BPP_RTOL, MSSSIM_ATOL, PSNR_ATOL = 1e-4, 2e-5, 1e-4


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed=0, h=128, w=128, block=8):
    """Blocky, compressible RGB (test_eval_aux.py's images)."""
    rng = np.random.RandomState(seed)
    base = rng.rand(h // block, w // block, 3)
    return (np.kron(base, np.ones((block, block, 1))) * 255).astype(np.uint8)


def _write_pngs(directory, n, h=96, w=96, block=8):
    directory.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray(_img(i, h, w, block)).save(directory / f'im{i}.png')
    return directory


# ---------------- baseline-codec tools ----------------

def test_compare_identical_and_equal_to_jax():
    img = _img()
    s, ms, ps = tcompare.compare(img, img)
    assert s == pytest.approx(1.0, abs=1e-9) and ms == pytest.approx(1.0, abs=1e-9)
    assert ps == float('inf')
    out, _ = tother.jp_compress(img, 30)
    assert tcompare.compare(img, out) == jcompare.compare(img, out)
    with pytest.raises(ValueError):
        tcompare.compare(img, img[:64])


def test_jpeg_quality_monotone_and_equal_to_jax():
    img = _img()
    (out_lo, bpp_lo), (out_hi, bpp_hi) = tother.jp_compress(img, 10), tother.jp_compress(img, 90)
    assert bpp_hi > bpp_lo
    _, ms_lo, _ = tcompare.compare(img, out_lo, calc_ssim=False)
    _, ms_hi, _ = tcompare.compare(img, out_hi, calc_ssim=False)
    assert ms_hi > ms_lo
    j_out, j_bpp = jother.jp_compress(img, 10)
    assert bpp_lo == j_bpp
    np.testing.assert_array_equal(out_lo, j_out)


def test_webp_and_jp2k_equal_to_jax():
    img = _img(1)
    for fn, q in (('webp_compress', 50), ('jp2k_compress', 0.5)):
        out, bpp = getattr(tother, fn)(img, q)
        assert out.shape == img.shape and bpp > 0
        j_out, j_bpp = getattr(jother, fn)(img, q)
        assert bpp == j_bpp
        np.testing.assert_array_equal(out, j_out)
    assert tother.kakadu_available() == jother.kakadu_available()
    assert tother.bpg_available() == jother.bpg_available()
    if not tother.bpg_available():
        with pytest.raises(RuntimeError, match='bpgenc'):
            tother.bpg_compress(img, 30)


def test_measures_csv_roundtrip_and_equal_to_jax(tmp_path):
    img_dir = _write_pngs(tmp_path / 'imgs', 2, 128, 128)
    t_out, j_out = str(tmp_path / 'out_t'), str(tmp_path / 'out_j')
    tother.create_curves_for_images(str(img_dir), t_out, grid=[20, 50, 80], mode='jp')
    jother.create_curves_for_images(str(img_dir), j_out, grid=[20, 50, 80], mode='jp')
    files = tother.all_measures_file_ps(t_out)
    assert [os.path.basename(f) for f in files] == ['im0_out.csv', 'im1_out.csv']
    for f in files:
        with open(f) as a, open(os.path.join(j_out, os.path.basename(f))) as b:
            assert a.read() == b.read()
    rows = list(tother.read_measures(files[0], 'ms-ssim'))
    assert len(rows) == 3
    assert [b for b, _ in rows] == sorted(b for b, _ in rows)
    with pytest.raises(ValueError):
        list(tother.read_measures(files[0], 'lpips'))


def test_codec_distance_sign_and_equal_to_jax(tmp_path, monkeypatch):
    img_dir = _write_pngs(tmp_path / 'imgs', 2)
    root = tmp_path / 'codecs'
    tother.create_curves_for_images(str(img_dir), str(root / tcd.CODECS['kodak']['jp']),
                                    grid=[10, 30, 50, 70, 90], mode='jp')
    monkeypatch.setattr(tconstants, 'OTHER_CODECS_ROOT', str(root))
    monkeypatch.setattr(jconstants, 'OTHER_CODECS_ROOT', str(root))
    cd = tcd.CodecDistance('kodak', 'jp', 'ms-ssim')
    jd = jcd.CodecDistance('kodak', 'jp', 'ms-ssim')
    mid_bpp = 0.5 * (cd._grid[0] + cd._grid[-1])
    assert cd.distance(mid_bpp, 1.0) > 0 > cd.distance(mid_bpp, 0.0)
    for bpp in np.linspace(cd._grid[0], cd._grid[-1], 7):
        assert cd.distance(bpp, 0.9) == jd.distance(bpp, 0.9)
    with pytest.raises(ValueError, match='outside'):
        cd.distance(cd._grid[-1] + 1.0, 0.9)
    with pytest.raises(tcd.CodecDistanceReadException):
        tcd.CodecDistance('kodak', 'bpg', 'ms-ssim')      # no curves measured


def test_binary_search_hits_target():
    q = tother.binary_search(lambda q: q * q, target=9.0, lo=0, hi=10, eps=1e-4)
    assert q == pytest.approx(3.0, abs=1e-3)
    out, bpp, q = tother.compress_to_target_bpp(_img(2), 'jp', 0.5)
    assert abs(bpp - 0.5) < 0.1 and out.shape == (128, 128, 3)


def test_plotter_writes_png(tmp_path, monkeypatch):
    monkeypatch.setattr(tconstants, 'OTHER_CODECS_ROOT', str(tmp_path / 'none'))
    out = str(tmp_path / 'plot.png')
    tplotter.interpolated_curve(str(tmp_path), '', 'kodak', output_path=out, paper_plot=True)
    assert os.path.getsize(out) > 1000


def test_full_analysis_path(tmp_path, monkeypatch):
    """Codec curves -> codec_distance -> plotter with a run of ours: the
    port's measures.csv read back by the port's and the JAX package's
    readers, and the curve of ours interpolated alike."""
    img_dir = _write_pngs(tmp_path / 'imgs', 2)
    root = tmp_path / 'codecs'
    tother.create_curves_for_images(str(img_dir), str(root / tcd.CODECS['kodak']['jp']),
                                    grid=[10, 30, 50, 70, 90], mode='jp')
    monkeypatch.setattr(tconstants, 'OTHER_CODECS_ROOT', str(root))

    log_root = tmp_path / 'logs'
    job_ids = []
    for run, (bpp0, bpp1) in enumerate([(0.3, 0.5), (0.6, 0.8)]):
        log_dir = tlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], str(log_root))
        ckpt_dir = tlogdir.ckpt_dir_for_log_dir(log_dir)
        os.makedirs(ckpt_dir)
        vd = tval_files.ValidationDirs(ckpt_dir, str(log_root), 'kodak')
        mw = tval_files.MeasuresWriter(vd.out_dir)
        for name, bpp, ms, ps in [('im0.png', bpp0, 0.95 + run / 50, 28.0),
                                  ('im1.png', bpp1, 0.97 + run / 50, 30.0)]:
            mw.append(name, {'bpp': bpp, 'ms-ssim': ms, 'psnr': ps})
        mw.close()
        rows = list(tval_files.MeasuresReader(vd.out_dir).iter_metric('psnr'))
        assert rows == list(jval_files.MeasuresReader(vd.out_dir).iter_metric('psnr'))
        assert rows == [('im0.png', bpp0, 28.0), ('im1.png', bpp1, 30.0)]
        job_ids.append(tlogdir.log_date_from_log_dir(log_dir))
        assert tval_files.MeasuresReader(vd.out_dir).get_job_id() == job_ids[-1]

    readers = tcd.get_measures_readers(str(log_root), ','.join(job_ids), 'kodak')
    assert len(readers) == 2
    g, v = tcd.interpolate_ours(readers, tcd.DEFAULT_BPP_GRID, 'linear', 'ms-ssim')
    jg, jv = jcd.interpolate_ours(readers, jcd.DEFAULT_BPP_GRID, 'linear', 'ms-ssim')
    assert g == jg and v == jv and len(g) == 3      # the bins in both images' ranges
    for style in ({'plot_interp_of_ours': True}, {'plot_interp_of_ours': False,
                                                 'plot_mean_of_ours': True}):
        out = str(tmp_path / 'rd.png')
        tplotter.interpolated_curve(str(log_root), ','.join(job_ids), 'kodak',
                                    output_path=out, paper_plot=True, **style)
        assert os.path.getsize(out) > 1000
        os.remove(out)


def test_bpg_header_parser():
    """Crafted BPG headers: ue7 varints for width / height / picture length."""
    def ue7(v):
        out = []
        while True:
            out.append(v & 0x7F)
            v >>= 7
            if not v:
                break
        return bytes(b | 0x80 for b in out[:0:-1]) + bytes(out[:1])

    assert ue7(1218) == bytes([0b10001001, 0b01000010])
    data = (tother.BPGInfo.MAGIC + b'\x00\x00' + ue7(768) + ue7(512) + ue7(321)
            + b'\x42' * 321 + b'trailer-ignored')
    info = tother.BPGInfo(data)
    assert (info.width, info.height, info.picture_bytes) == (768, 512, 321)
    assert info.bpp == jother.BPGInfo(data).bpp == 321 * 8 / (768 * 512)
    data2 = tother.BPGInfo.MAGIC + b'\x00\x00' + ue7(16) + ue7(16) + ue7(0) + b'\x01' * 77
    assert tother.BPGInfo(data2).picture_bytes == 77
    with pytest.raises(ValueError):
        tother.BPGInfo(b'NOPE' + data[4:])


def test_jpeg_content_length():
    img = _img(3, 64, 64)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, 'JPEG', quality=80)
    data = buf.getvalue()
    n = tother.jpeg_content_length(data)
    assert n == jother.jpeg_content_length(data) and 0 < n < len(data)
    assert tother.jp_compress(img, 80)[1] == n * 8 / (64 * 64)
    with pytest.raises(ValueError):
        tother.jpeg_content_length(b'\x00' * 16)


# ---------------- the validation path against JAX, trained weights ----------------

@pytest.fixture(scope='module')
def crops(tmp_path_factory):
    """Two 64x96 crops of natkodak24 images and one 50x61 crop (padded to
    56x64 by the eval path), as PNGs in one directory."""
    d = tmp_path_factory.mktemp('val') / 'crops'        # 'crops' names the dataset
    d.mkdir()
    src = [np.asarray(Image.open(os.path.join(NATKODAK, f'nat1000{i}.png')).convert('RGB'))
           for i in range(3)]
    for name, arr in (('crop0.png', src[0][100:164, 200:296]),
                      ('crop1.png', src[1][300:364, 500:596]),
                      ('crop2.png', src[2][10:60, 40:101])):
        Image.fromarray(np.ascontiguousarray(arr)).save(d / name)
    return d


@pytest.fixture(scope='module')
def trained_models():
    """(JAX EvalModel, port EvalModel) with the trained weights; the JAX
    model is shared so that its jitted executables are compiled once."""
    tree = tweights.load_npz(ASSET)
    jae, _ = jconfig.parse_spec('cvpr/low', 'ae')
    jpc, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    jm = jvalidate.EvalModel(jae, jpc)
    jm.set_params(tree['params'], tree['batch_stats'])
    tae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    tpc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tm = tvalidate.EvalModel(tae_cfg, tpc_cfg, device='cpu')
    tm.set_params({'ae': tweights.ae_state_dict(tree['params']['ae'], tree['batch_stats'],
                                                tm.ae),
                   'pc': tweights.pc_state_dict(tree['params']['pc'])})
    return jm, tm, tree


def _buckets(crops_dir):
    paths = sorted(str(p) for p in crops_dir.glob('*.png'))
    return list(tvalidate.iter_shape_buckets(
        tii.ImagesIterator(paths, 'crops').iter_padded(pad=8), batch_size=2))


def _assert_measures_close(a, b):
    assert a['bpp'] == pytest.approx(b['bpp'], rel=BPP_RTOL, abs=0)
    assert abs(a['ms-ssim'] - b['ms-ssim']) <= MSSSIM_ATOL
    assert abs(a['psnr'] - b['psnr']) <= PSNR_ATOL


def test_fetch_many_matches_jax(trained_models, crops):
    jm, tm, _ = trained_models
    buckets = _buckets(crops)
    assert [(len(n), p) for n, _, p in buckets] == [(2, (0, 0, 64, 96)), (1, (3, 1, 50, 61))]
    for names, imgs, pad_info in buckets:
        got = tm.fetch_many(imgs, pad_info=pad_info, pad_batch_to=2)
        want = jm.fetch_many(imgs, pad_info=pad_info, pad_batch_to=2)
        assert len(got) == len(names)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {'bpp', 'ms-ssim', 'psnr', 'sym', 'img_out'}
            _assert_measures_close(g, w)
            assert g['sym'].shape == w['sym'].shape == (imgs[0].shape[0] // 8,
                                                         imgs[0].shape[1] // 8, 32)
            assert int((g['sym'] != w['sym']).sum()) <= 1e-3 * g['sym'].size
            assert g['img_out'].shape == w['img_out'].shape == pad_info[2:] + (3,)
            assert g['img_out'].dtype == np.uint8
            diff = np.abs(g['img_out'].astype(int) - w['img_out'].astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _measures(out_dir):
    with open(os.path.join(out_dir, 'measures.csv')) as f:
        lines = f.read().splitlines()
    assert lines[0] == 'img_name,bpp,ms-ssim,psnr'
    return [(name, dict(zip(('bpp', 'ms-ssim', 'psnr'), map(float, rest))))
            for name, *rest in (line.split(',') for line in lines[1:])]


def test_validate_matches_jax(trained_models, crops, tmp_path):
    """A whole validate() on each side, each from its own checkpoint of the
    same weights (the port's through val_torch.py, as train_torch.py's
    checkpoints are laid out): the same measures.csv rows and summary."""
    import val_torch
    jm, _, tree = trained_models
    jroot, troot = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jlog = jlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], jroot)
    jckpt.Saver(jlogdir.ckpt_dir_for_log_dir(jlog)).save(
        {'params': tree['params'], 'batch_stats': tree['batch_stats']}, 9000)
    jvd = jval_files.ValidationDirs(jlogdir.ckpt_dir_for_log_dir(jlog), jroot, 'crops')
    jvalidate.validate(jvd, jii.ImagesIterator(sorted(str(p) for p in crops.glob('*.png')),
                                               'crops'),
                       jvalidate.OutputFlags(eval_batch=2), eval_model=jm)

    ae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    state = ttrainer.Trainer(ae_cfg, pc_cfg, device='cpu').init_state(0)
    tweights.load_trained(ASSET, state.ae, state.pc, device='cpu')
    tlog = tlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], troot)
    tckpt.Saver(tlogdir.ckpt_dir_for_log_dir(tlog)).save(state.state_dict(), 9000)
    job = tlogdir.log_date_from_log_dir(tlog)
    val_torch.main([troot, job, str(crops), '--device', 'cpu', '-s', '-1', '--save_ours'])

    t_out = os.path.join(troot, f'{job} crops')
    got, want = _measures(t_out), _measures(jvd.out_dir)
    assert [n for n, _ in got] == [n for n, _ in want] == ['crop0.png', 'crop1.png',
                                                             'crop2.png']
    for (_, g), (_, w) in zip(got, want):
        _assert_measures_close(g, w)
    with open(os.path.join(t_out, 'summary_9000.json')) as f:
        t_sum = json.load(f)
    with open(os.path.join(jvd.out_dir, 'summary_9000.json')) as f:
        j_sum = json.load(f)
    assert set(t_sum) == set(j_sum) == {'iteration', 'bpp', 'ms-ssim', 'psnr'}
    assert t_sum['iteration'] == j_sum['iteration'] == 9000
    _assert_measures_close(t_sum, j_sum)
    assert tval_files.ValidationDirs(tlogdir.ckpt_dir_for_log_dir(tlog), troot,
                                     'crops').get_validated_checkpoints() == [9000]
    for name, (h, w) in (('crop0.png', (64, 96)), ('crop2.png', (50, 61))):
        with Image.open(os.path.join(t_out, 'imgs', name)) as im:
            assert im.size == (w, h)
    # validated already: a second call leaves the measures as they are
    mtime = os.path.getmtime(os.path.join(t_out, 'measures.csv'))
    val_torch.main([troot, job, str(crops), '--device', 'cpu', '-s', '-1'])
    assert os.path.getmtime(os.path.join(t_out, 'measures.csv')) == mtime


def test_val_torch_refuses_several_devices_and_cuda_without_card(crops, tmp_path):
    """--num_devices 2 --device cpu validates data-parallel over two CPU
    copies of the model: the same measures.csv as one device. 'cuda' with
    no card raises."""
    import val_torch
    ae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    state = ttrainer.Trainer(ae_cfg, pc_cfg, device='cpu').init_state(0)
    tweights.load_trained(ASSET, state.ae, state.pc, device='cpu')
    measures = []
    for n in ('1', '2'):
        root = str(tmp_path / n)
        log = tlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], root)
        tckpt.Saver(tlogdir.ckpt_dir_for_log_dir(log)).save(state.state_dict(), 9000)
        job = tlogdir.log_date_from_log_dir(log)
        val_torch.main([root, job, str(crops), '--device', 'cpu', '-s', '-1',
                        '--num_devices', n])
        measures.append(_measures(os.path.join(root, f'{job} crops')))
    assert measures[0] == measures[1] and len(measures[0]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            val_torch.main([str(tmp_path), 'x', NATKODAK])


def test_checkpoint_sweep_takes_every_nth_and_the_last(trained_models, crops, tmp_path):
    """ckpt_step 2 over checkpoints 1..5: 1, 3 and 5, each with its summary."""
    _, tm, _ = trained_models
    log_dir = tlogdir.create_unique_log_dir(['cvpr/low', 'cvpr/res_shallow'], str(tmp_path))
    saver = tckpt.Saver(tlogdir.ckpt_dir_for_log_dir(log_dir), max_to_keep=10)
    model = {'model': {'ae': tm.ae.state_dict(), 'pc': tm.pc.state_dict()}}
    for itr in range(1, 6):
        saver.save(model, itr)
    vd = tval_files.ValidationDirs(saver.ckpt_dir, str(tmp_path), 'crops')
    it = tii.ImagesIterator([str(crops / 'crop2.png')], 'crops')
    tvalidate.validate(vd, it, tvalidate.OutputFlags(ckpt_step=2, eval_batch=1),
                       eval_model=tm)
    assert vd.get_validated_checkpoints() == [1, 3, 5]
    assert sorted(f for f in os.listdir(vd.out_dir) if f.startswith('summary_')) == [
        'summary_1.json', 'summary_3.json', 'summary_5.json']


# ---------------- unpadded-frame metrics and shape buckets ----------------

def _tiny_eval_model():
    ae, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    em = tvalidate.EvalModel(ae.replace(arch_param_B=1, num_chan_bn=4,
                                        distortion_to_minimize='mse'),
                             pc.replace(arch_param__k=4), device='cpu')
    tae.init_params(em.ae, 0)
    tpc.init_params(em.pc, 1)
    return em


def test_metrics_computed_on_unpadded_frame():
    rng = np.random.RandomState(1)
    oh, ow = 50, 61
    padded, _ = tii.add_padding((rng.rand(oh, ow, 3) * 255).astype(np.uint8), 8)
    assert padded.shape == (56, 64, 3)
    pad_info = ((56 - oh) // 2, (64 - ow) // 2, oh, ow)
    em = _tiny_eval_model()
    (otp,) = em.fetch_many([padded], pad_info=pad_info)
    assert otp['img_out'].shape == (oh, ow, 3)
    crop = padded[pad_info[0]:pad_info[0] + oh, pad_info[1]:pad_info[1] + ow]
    np.testing.assert_allclose(float(otp['psnr']), tmetrics.psnr_np(crop, otp['img_out']),
                               rtol=1e-4)
    # bpp over the unpadded pixel count: the same bits, another divisor
    (otp_full,) = em.fetch_many([padded])
    np.testing.assert_allclose(float(otp['bpp']) * oh * ow,
                               float(otp_full['bpp']) * 56 * 64, rtol=1e-5)
    assert abs(float(otp_full['psnr']) - float(otp['psnr'])) > 1e-6


def test_identical_images_give_inf_psnr_without_warning():
    import warnings
    img = np.full((16, 16, 3), 128, np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert tmetrics.psnr_np(img, img) == float('inf')


def test_tail_batches_share_one_shape():
    """pad_batch_to gives every batch of a shape one shape (on the card:
    one cuDNN problem shape), and a tail image's results are those it gets
    in a full batch."""
    em = _tiny_eval_model()
    shapes = []
    hook = em.ae.encoder.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
    rng = np.random.RandomState(2)
    imgs = [(rng.rand(32, 32, 3) * 255).astype(np.uint8) for _ in range(5)]
    try:
        full = em.fetch_many(imgs[:4], pad_batch_to=4)
        tail = em.fetch_many(imgs[:2], pad_batch_to=4)
        one = em.fetch_many(imgs[4:], pad_batch_to=4)
    finally:
        hook.remove()
    assert shapes == [(4, 32, 32, 3)] * 3
    assert len(full) == 4 and len(tail) == 2 and len(one) == 1
    for a, b in zip(tail, full):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_iter_shape_buckets_interleaved():
    """A dataset alternating between two shapes still forms full batches."""
    def gen():
        for i in range(8):
            shape = (32, 32, 3) if i % 2 == 0 else (16, 48, 3)
            yield f'img{i}', np.zeros(shape, np.uint8), (0, 0) + shape[:2]

    batches = list(tvalidate.iter_shape_buckets(gen(), batch_size=4))
    assert len(batches) == 2
    for names, imgs, pad_info in batches:
        assert len(imgs) == 4 and len({im.shape for im in imgs}) == 1
        assert pad_info[2:] == imgs[0].shape[:2]


def test_iter_padded_yields_pad_geometry(tmp_path):
    rng = np.random.RandomState(3)
    p = tmp_path / 'img.png'
    Image.fromarray((rng.rand(30, 41, 3) * 255).astype(np.uint8)).save(p)
    (name, arr, pad_info), = list(tii.ImagesIterator([str(p)], 'test').iter_padded(pad=8))
    assert name == 'img.png' and arr.shape == (32, 48, 3)
    assert pad_info == ((32 - 30) // 2, (48 - 41) // 2, 30, 41)
    (_, arr2), = list(tii.ImagesIterator([str(p)], 'test').iter_imgs(pad=8))
    np.testing.assert_array_equal(arr, arr2)


# ---------------- real bpp ----------------

@pytest.mark.parametrize('pc_spec', ['cvpr/res_shallow', 'base'])
def test_entropy_consistency_triangle(pc_spec):
    """Real, theoretical and loss bpp of one image through the port's
    LatentCodec on the CPU (kernels' plain versions): K=3 and K=5 (the
    reference's test_real_bpp.py bounds; lanes: the codec's R = 32)."""
    ae_cfg, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = tconfig.parse_spec(pc_spec, 'pc')
    ae_cfg = ae_cfg.replace(arch_param_B=1, num_chan_bn=8)
    pc_cfg = pc_cfg.replace(arch_param__k=8)
    ae = tae.init_params(tae.CVPRAutoencoder(ae_cfg, device='cpu'), 0)
    pc = tpc.init_params(tpc.ProbClassifier(pc_cfg, ae_cfg.num_centers, device='cpu'), 1)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 48, 64, 3).astype(np.float32) * 255)
    centers = ae.encoder.centers.detach()
    enc = ae.encode(x)
    with torch.no_grad():
        bc = pc.bitcost(enc.qhard, enc.symbols, tpc.auto_pad_value(pc_cfg, centers, pc))
    bpp_loss = float(tbits.bitcost_to_bpp(bc, x))
    syms = enc.symbols[0].permute(2, 0, 1).numpy()
    codec = tcodec.LatentCodec(pc, pc_cfg, device='cpu')
    result = codec.roundtrip(syms, centers.numpy())          # bit-exact gate
    assert tcodec.stream_impl_id(result.bitstream) == (5 if pc_cfg.kernel_size == 3 else 6)
    bpp_theory = result.theoretical_bits / (48 * 64)
    assert bpp_theory == pytest.approx(bpp_loss, rel=2e-2), (bpp_theory, bpp_loss)
    overhead_bits = 8 * (4 + 2 + 6 + 4 + 4) + tck.R * (32 + 32 + 16)
    assert result.num_bits <= result.theoretical_bits + overhead_bits


@pytest.mark.parametrize('shape', [(8, 4, 6), (8, 1, 8), (2, 3, 2)])
def test_small_latents_round_trip(shape):
    """Latents of images under ~64 pixels a side (a 32x48 image gives
    (C, 4, 6)) have wavefront steps where a layer has no cell; the plain
    K=3 versions take them (the codec on the CPU raised there before)."""
    cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=8)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, 6, device='cpu'), 1)
    syms = np.random.RandomState(0).randint(0, 6, shape).astype(np.int8)
    result = tcodec.LatentCodec(pc, cfg, device='cpu').roundtrip(
        syms, np.linspace(-2, 2, 6).astype(np.float32))
    assert result.num_bits > 0


# ---------------- the training loop's monitor, image dumps and registry ----------------

@pytest.fixture
def config_roots(tmp_path, monkeypatch):
    ae_root, pc_root = tmp_path / 'cfg_ae', tmp_path / 'cfg_pc'
    ae_root.mkdir()
    pc_root.mkdir()
    (ae_root / 'tiny').write_text(TINY_AE)
    (pc_root / 'tiny_pc').write_text(TINY_PC)
    monkeypatch.setenv('CONFIG_BASE_AE', str(ae_root))
    monkeypatch.setenv('CONFIG_BASE_PC', str(pc_root))


def _test_events(log_dir):
    with open(os.path.join(log_dir, 'events_test.jsonl')) as f:
        return [json.loads(line) for line in f]


def test_train_loop_d_bpg_image_dumps_and_registry(tmp_path, config_roots, monkeypatch):
    """train_torch.py on tiny configs: d_BPG is NaN without BPG curves and
    the MS-SSIM distance to the curve with them (JPEG curves of 32-pixel
    blocks stand in the 'bpg' slot, covering the tiny model's ~0.17 bpp);
    the test images are dumped; a description lands in the registry."""
    import train_torch
    log_root = str(tmp_path / 'logs')
    args = ['tiny', 'tiny_pc', '-dtrain', 'synthetic:4', '-dtest', 'synthetic:2', '-o',
            log_root, '--device', 'cpu', '-ltrain', '3', '-ltest', '3', '-lsave', '1000',
            '--max_steps', '3']
    log_dir = train_torch.main(args + ['-d', 'tiny run'])
    (ev,) = _test_events(log_dir)
    assert ev['step'] == 3 and np.isnan(ev['d_BPG'])
    assert sorted(os.listdir(os.path.join(log_dir, 'imgs'))) == [
        f'00000003_{i}_{k}.png' for i in range(2) for k in ('hm', 'in', 'out')]
    for k, size in (('in', (32, 32)), ('out', (32, 32)), ('hm', (4, 4))):
        with Image.open(os.path.join(log_dir, 'imgs', f'00000003_0_{k}.png')) as im:
            assert im.size == size
    (run,) = tregistry.read_runs(log_root)
    assert (run['description'], run['ae_config'], run['pc_config'], run['log_date']) == (
        'tiny run', 'tiny', 'tiny_pc', tlogdir.log_date_from_log_dir(log_dir))

    img_dir = _write_pngs(tmp_path / 'imgs', 2, block=32)
    root = tmp_path / 'codecs'
    tother.create_curves_for_images(str(img_dir), str(root / tcd.CODECS['kodak']['bpg']),
                                    grid=[1, 10, 30, 50, 70, 95], mode='jp')
    monkeypatch.setattr(tconstants, 'OTHER_CODECS_ROOT', str(root))
    log_dir2 = train_torch.main(args + ['-dcodec', 'kodak'])
    (ev2,) = _test_events(log_dir2)
    want = tcd.CodecDistance('kodak', 'bpg', 'ms-ssim').distance(ev2['bpp'],
                                                                ev2['ms_ssim_eval'])
    assert np.isfinite(ev2['d_BPG']) and ev2['d_BPG'] == want
    assert len(tregistry.read_runs(log_root)) == 1       # no description, no record
