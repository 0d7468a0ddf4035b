"""The port's codec API on the CPU: submit / finish against one straight
pass, device_out, one-image encode / decode / roundtrip, errors at finish,
BppFetcher against the JAX package's, and bench_torch.run_pipeline.

Both coders run their kernels' plain versions (CPU tensors); the JAX
reference runs under jax.jit (its 'ring' codec on the CPU).
"""

import os

import jax
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import bpp as jbpp
from imgcomp_cvpr_tpu.coding import codec as jcodec
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import bpp as tbpp
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.coding import planar_kernel as plk
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 6
CENTERS = np.linspace(-2.0, 2.0, L).astype(np.float32)
CASES = {3: (16, 24, 36), 5: (4, 8, 8)}     # kernel size -> latent shape


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _pc(K, seed=0):
    """Seeded context model, kf = 8: `cvpr/res_shallow` (K=3) or `pc base`
    (K=5)."""
    cfg, _ = tconfig.parse_spec('cvpr/res_shallow' if K == 3 else 'base', 'pc')
    cfg = cfg.replace(arch_param__k=8)
    assert cfg.kernel_size == K
    return tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), seed), cfg


def _straight_pass(pc, cfg, syms):
    """The encode as one pass, with no handle in between (the flow of the
    encode_batch that the submit / finish split replaced): tables, reverse
    encode, serialize each image."""
    b, shape = syms.shape[0], tuple(syms.shape[1:])
    centers = torch.from_numpy(CENTERS)
    t = torch.from_numpy(syms).int()
    if cfg.kernel_size == 3:
        fsel, ssel = ck.wavefront_forward(ck.MODE_ENCODE, tcc.fold_weights(pc, centers), shape,
                                          true_syms=t.reshape(b, -1))
        totals = ck.lane_totals(ck.build_schedule(shape))
        impl = tcodec.IMPL_CUDA
    else:
        coder = tpcodec.PlanarCoder(pc, cfg, device='cpu')
        fsel, ssel = coder.encode_tables(t, tpcodec.fold_planar(pc, centers))
        totals = coder.lane_totals(shape)
        impl = tcodec.IMPL_CUDA_PLANAR
    tail = totals.max() >= tcodec.TAIL_MIN_LANE_SYMBOLS
    x0 = 1 if tail else trans.RANS_L
    if cfg.kernel_size == 3:
        words, n_words, states, k = ck.rans_reverse(fsel, ssel, shape, x0)
    else:
        words, n_words, states, k = plk.plane_reverse(fsel, ssel, shape, 5, x0)
    out = []
    for i in range(b):
        out.append(tcodec.serialize_stream(
            shape, words[i, :n_words[i]].numpy()[::-1].astype(np.uint32),
            states[i].numpy().view(np.uint32), tcodec.symbol_crc(syms[i]), impl_id=impl,
            k=k[i].numpy() if tail else None))
    return out


@pytest.fixture(scope='module', params=[3, 5], ids=['K3', 'K5'])
def case(request):
    """A codec, 16 symbol volumes and their straight-pass streams."""
    K = request.param
    pc, cfg = _pc(K, seed=K)
    syms = np.random.RandomState(K).randint(0, L, (16,) + CASES[K]).astype(np.int8)
    return dict(K=K, pc=pc, cfg=cfg, syms=syms, lc=tcodec.LatentCodec(pc, cfg, device='cpu'),
                streams=_straight_pass(pc, cfg, syms))


@pytest.mark.parametrize('b', [1, 3, 16])
def test_submit_finish_streams_equal_straight_pass(case, b):
    """finish(submit()) writes, at B = 1, 3 and 16, the bytes of the
    straight pass at B = 16 (streams do not depend on the batch); numpy
    input carries its symbols into the results, a tensor does not."""
    lc, syms = case['lc'], case['syms']
    res = lc.encode_batch_finish(lc.encode_batch_submit(syms[:b], CENTERS))
    assert [r.bitstream for r in res] == case['streams'][:b]
    assert all(np.array_equal(r.symbols, s) for r, s in zip(res, syms[:b]))
    res_t = lc.encode_batch(torch.from_numpy(syms[:b]), torch.from_numpy(CENTERS))
    assert [r.bitstream for r in res_t] == case['streams'][:b]
    assert all(r.symbols is None for r in res_t)


def test_two_outstanding_handles(case):
    """Two submits outstanding, finished in order, give the straight-pass
    bytes; a stream-word prediction that falls short is made up at finish."""
    lc, syms = case['lc'], torch.from_numpy(case['syms'])
    coder = lc.coder(lc.impl_id)
    coder._cols[CASES[case['K']]] = 1            # fewer words than any stream has
    h1 = lc.encode_batch_submit(syms[:3], CENTERS)
    h2 = lc.encode_batch_submit(syms[3:4], CENTERS)
    assert h1.host[0].shape[1] == 1
    r1, r2 = lc.encode_batch_finish(h1), lc.encode_batch_finish(h2)
    assert [r.bitstream for r in r1 + r2] == case['streams'][:4]
    assert coder._cols[CASES[case['K']]] > 1


def test_decode_device_out_and_one_image(case):
    """decode_batch_finish(device_out=False) is a host np.int32 array equal
    to the device_out=True tensor (the port's default); encode / decode /
    roundtrip of one image equal entry 0 of the batch; two decode handles
    outstanding each verify."""
    lc, syms = case['lc'], case['syms']
    streams = case['streams']
    d1 = lc.decode_batch_submit(streams[:2], CENTERS)
    d2 = lc.decode_batch_submit(streams[2:3], CENTERS)
    on_dev = lc.decode_batch_finish(d1)
    host = lc.decode_batch_finish(d2, verify=True, device_out=False)
    assert isinstance(on_dev, torch.Tensor) and on_dev.dtype == torch.int32
    assert isinstance(host, np.ndarray) and host.dtype == np.int32
    np.testing.assert_array_equal(on_dev.numpy(), syms[:2])
    np.testing.assert_array_equal(host, syms[2:3])
    one = lc.encode(syms[0], CENTERS)
    assert one.bitstream == streams[0]
    dec = lc.decode(one.bitstream, CENTERS)
    assert dec.dtype == np.int32 and dec.shape == syms[0].shape
    np.testing.assert_array_equal(dec, syms[0])
    assert lc.roundtrip(syms[0], CENTERS).bitstream == streams[0]


def test_bad_symbol_raises_at_finish_at_the_latest(case):
    """Host symbols out of range raise at submit; a tensor on the codec's
    device raises at finish (a device flag, no wait in submit)."""
    lc, syms = case['lc'], case['syms'][:1].astype(np.int64)
    bad = syms.copy()
    bad[0, 0, 0, 0] = L
    with pytest.raises(ValueError, match='must lie in'):
        lc.encode_batch_submit(bad, CENTERS)
    bad[0, 0, 0, 0] = -1
    h = lc.encode_batch_submit(torch.from_numpy(bad), CENTERS)
    with pytest.raises(ValueError, match='must lie in'):
        lc.encode_batch_finish(h)


def test_corrupt_stream_raises_at_finish(case):
    lc = case['lc']
    bs = bytearray(case['streams'][0])
    bs[-3] ^= 0x5A
    h = lc.decode_batch_submit([bytes(bs)], CENTERS)
    with pytest.raises(ValueError, match='CRC'):
        lc.decode_batch_finish(h, device_out=False)


def test_k_cap_reencode_at_finish(monkeypatch):
    """A lane whose warmup passes K_CAP sends the batch back through the
    reverse encoder with x0 = RANS_L at finish: the streams then carry no
    k-table and still decode (K_CAP lowered to 0 to force the case)."""
    pc, cfg = _pc(3, seed=9)
    lc = tcodec.LatentCodec(pc, cfg, device='cpu')
    syms = np.random.RandomState(9).randint(0, L, (2,) + CASES[3]).astype(np.int8)
    h = lc.encode_batch_submit(syms, CENTERS)
    assert h.tail and h.reverse is not None
    monkeypatch.setattr(tcodec, 'K_CAP', 0)
    res = lc.encode_batch_finish(h)
    assert all(tcodec.deserialize_stream(r.bitstream)[4] is None for r in res)
    np.testing.assert_array_equal(
        lc.decode_batch([r.bitstream for r in res], CENTERS, device_out=False), syms)


def test_bpp_fetcher_matches_jax():
    """BppFetcher over the port's codec: a bit-exact round trip, real bpp
    from its own stream, theoretical bpp within 1e-4 of the JAX package's
    BppFetcher with the same context model."""
    shape = (4, 6, 7)
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=8)
    jm = jpc.ProbClassifier(cfg, L)
    params = jm.init(jax.random.PRNGKey(1), (1, shape[1], shape[2], shape[0]))
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tm = tpc.ProbClassifier(tcfg.replace(arch_param__k=8), L, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    syms = np.random.RandomState(6).randint(0, L, shape).astype(np.int8)
    img = np.zeros((shape[1] * 8, shape[2] * 8, 3))
    npix = tbpp.num_pixels_in_image(img)
    assert npix == jbpp.num_pixels_in_image(img) == 48 * 56
    real, theo = tbpp.BppFetcher(tcodec.LatentCodec(tm, tcfg.replace(arch_param__k=8),
                                                    device='cpu'), CENTERS).get_bpp(syms, npix)
    _, jtheo = jbpp.BppFetcher(jcodec.LatentCodec(jm, cfg), params, CENTERS).get_bpp(syms, npix)
    assert abs(theo - jtheo) <= 1e-4 * jtheo
    assert real >= theo * 0.5 and real > 0


def test_bench_pipeline_recovers_the_symbols():
    """bench_torch.run_pipeline on the CPU at B=2, 64x96, the demo configs
    with the trained weights: the last pipelined batch decodes to the
    symbols the AE encoded, and its reconstruction is finite (the plain K=3
    decode takes ~11 s a batch at this latent, (32, 8, 12))."""
    import bench_torch
    ae_cfg, _ = tconfig.parse_spec('cvpr/low_demo', 'ae')
    pc_cfg, _ = tconfig.parse_spec('cvpr/res_shallow_demo', 'pc')
    ae = tae.CVPRAutoencoder(ae_cfg, device='cpu')
    pc = tpc.ProbClassifier(pc_cfg, ae_cfg.num_centers, device='cpu')
    ae, pc = tweights.load_trained(os.path.join(ROOT, 'assets', 'demo_trained_low_9000.npz'),
                                   ae, pc, device='cpu')
    codec = tcodec.LatentCodec(pc, pc_cfg, device='cpu')
    centers = ae.encoder.centers.detach().numpy()
    x = torch.from_numpy(bench_torch.natural_images(np.random.RandomState(0), 2, 64, 96))
    out = bench_torch.run_pipeline(codec, ae, x, centers, n_iter=2, device='cpu')
    assert torch.equal(out.symbols, bench_torch.ae_encode_syms(ae, x))
    assert out.x_out.shape == (2, 64, 96, 3) and bool(torch.isfinite(out.x_out).all())
    assert out.seconds > 0


def test_bench_main_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    import bench_torch
    assert bench_torch.main([]) != 0
