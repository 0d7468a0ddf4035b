"""The readers of kernel 2's two phases, ``k2_scan_ms`` (the decode scan)
and ``k2_encode_ms`` (the layer-parallel encode and its tables), on made-up
traces: each splits kernel 2's launches from the rest, and reads nothing
where kernel 2 did not run. Also the new configuration's work count: the
same formula at C=64 and kf=64."""

import pytest

from perfbench import harness
from perfbench.roofline import counts
from perfbench.trace import TraceSummary

MS = 1_000_000      # ns


def _trace(kernels, units=2):
    return TraceSummary(0.05, kernels, {}, {}, {}, {'units': units}, {})


KERNELS = [
    # kernel 2 as the card names its instances: the kf=64 scan and encode
    ('void wavefront_kernel<64, 6, 4, 2, true, 0>(FwdArgs)', 0, 7 * MS, 'codec_decode_submit'),
    ('void wavefront_kernel<64, 6, 4, 2, true, 0>(FwdArgs)', 10 * MS, 15 * MS,
     'codec_decode_submit'),
    ('void encode_layer_kernel<64, 6, 2, true, 0>(FwdArgs, int)', 16 * MS, 18 * MS,
     'codec_encode_submit'),
    ('void encode_layer_kernel<64, 6, 2, true, 0>(FwdArgs, int)', 18 * MS, 19 * MS,
     'codec_encode_submit'),
    ('void encode_tables_kernel<6>(FwdArgs)', 19 * MS, 20 * MS, 'codec_encode_submit'),
    # what is not kernel 2: the AE, its epilogue, kernels 3 and 5
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16', 20 * MS, 30 * MS, 'ae_encode'),
    ('void epilogue_vec<unsigned short>(Args, unsigned int, int)', 30 * MS, 31 * MS,
     'ae_encode'),
    ('rans_reverse_kernel(int, int, int, unsigned int)', 31 * MS, 32 * MS,
     'codec_encode_finish'),
    ('void plane_kernel<24, 6, true, 0>(PlaneArgs)', 32 * MS, 40 * MS, None),
    ('void plane_level_kernel<24>(PlaneArgs, int)', 40 * MS, 41 * MS, None),
]


@pytest.mark.parametrize('units', [1, 2, 4])
def test_scan_and_encode_split_kernel2(units):
    t = _trace(KERNELS, units)
    assert harness.reader('k2_scan_ms.stream').read(t) == pytest.approx(12.0 / units)
    assert harness.reader('k2_encode_ms.stream').read(t) == pytest.approx(4.0 / units)


@pytest.mark.parametrize('metric', ['k2_scan_ms.stream', 'k2_encode_ms.stream'])
def test_no_kernel2_reads_nothing(metric):
    others = [k for k in KERNELS if not k[0].startswith(('void wavefront', 'void encode'))]
    assert len(others) == 5
    assert harness.reader(metric).read(_trace(others)) is None
    assert harness.reader(metric).read(_trace([])) is None
    assert harness.reader(metric).read(_trace(KERNELS, units=0)) is None


def test_hi_wide_work_counts_c64_kf64():
    """counts.codec_work takes C and kf from the configuration: the scan's
    and the encode's operations scale by C=64 latent symbols and the kf=64
    context model's 241,792 operations a symbol."""
    cfg = harness.load_json('perfbench/configs/cvpr-hi-k3-wide.json')
    assert counts.cm_flops_per_symbol(3, 64, 6) == 241792
    assert counts.cm_weight_bytes(3, 64, 6) == 622872
    w = counts.codec_work(cfg, 512, 768, 16, 1e6)
    syms = 16 * 64 * 64 * 96
    f32 = counts.peaks()['f32_tflops'] * 1e12
    assert syms == 6291456
    assert w['k2_bound_s'] == pytest.approx(2 * syms * 241792 / f32)
    assert 0.045 < w['k2_bound_s'] < 0.046
