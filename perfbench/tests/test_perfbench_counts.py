"""The roofline's operation counts at small shapes against hand-worked
numbers, and the readers' arithmetic on a made-up trace."""

import json

import pytest

from perfbench import harness
from perfbench.roofline import counts
from perfbench.trace import TraceSummary


def test_same_conv_pairs():
    # stride 1, k 3 on 8: 8 outputs x 3 taps, less the 2 that read the padding
    assert counts.pairs_conv(8, 3, 1) == 22
    # stride 2, k 5 on 8: 4 outputs, pad 3 (lo 1): taps 4 + 5 + 5 + 3
    assert counts.pairs_conv(8, 5, 2) == 17


def test_transposed_conv_pairs():
    # 4 inputs, k 3, stride 2 -> 8 outputs, pad lo 0: the last input's last tap
    # lands on output 8, outside
    assert counts.pairs_conv_transpose(4, 3, 2) == 11


def test_masked_taps():
    assert counts.kept_taps(3, True) == 9 + 4 and counts.kept_taps(3, False) == 9 + 5
    assert counts.kept_taps(5, True) == 50 + 12 and counts.kept_taps(5, False) == 50 + 13
    assert counts.kept_taps(5, False, current_slice_only=True) == 13


def test_context_model_flops():
    # K=3, kf=24, L=6: 2 (13*24 + 2*14*24*24 + 14*24*6)
    assert counts.cm_flops_per_symbol(3, 24, 6) == 36912


def test_ae_flops_small():
    # one 16x16 image, C=2, no residual blocks beyond the final one
    enc, dec = counts.ae_flops(16, 16, 2, 0)
    p = counts.pairs_conv
    want_enc = 2 * (p(16, 5, 2) ** 2 * 3 * 64 + p(8, 5, 2) ** 2 * 64 * 128
                    + 2 * p(4, 3, 1) ** 2 * 128 * 128 + p(4, 5, 2) ** 2 * 128 * 3)
    assert enc == want_enc
    t = counts.pairs_conv_transpose
    want_dec = 2 * (t(2, 3, 2) ** 2 * 2 * 128 + 2 * p(4, 3, 1) ** 2 * 128 * 128
                    + t(4, 5, 2) ** 2 * 128 * 64 + t(8, 5, 2) ** 2 * 64 * 3)
    assert dec == want_dec


def test_codec_work_and_readers():
    cfg = harness.load_json('perfbench/configs/cvpr-low-k3.json')
    pk = counts.peaks()
    w = counts.codec_work(cfg, 16, 16, 2, 10)
    enc, dec = counts.ae_flops(16, 16, 32, 5)
    cm = 2 * 2 * 32 * 2 * 2 * 36912
    assert w['step_min_s'] == pytest.approx(2 * (enc + dec) / (pk['bf16_tflops'] * 1e12)
                                            + cm / (pk['f32_tflops'] * 1e12))
    # two kernel-2 launches of 1 ms each in a 10 ms window over 2 units
    kernels = [('void wavefront_kernel<24>(FwdArgs)', 0, 1_000_000, 'codec_decode_submit'),
               ('void encode_layer_kernel<24>(FwdArgs, int)', 2_000_000, 3_000_000,
                'codec_encode_submit'),
               ('sm90_xmma_fprop', 4_000_000, 8_000_000, 'ae_encode')]
    t = TraceSummary(0.01, kernels, {}, {}, {}, {'units': 2}, w)
    assert t.busy_s == pytest.approx(0.006)
    assert harness.reader('device_idle_pct.stream').read(t) == pytest.approx(40.0)
    assert harness.reader('k2_roofline.stream').read(t) == pytest.approx(
        100 * w['k2_bound_s'] * 2 / 0.002)
    assert harness.reader('ae_device_ms.stream').read(t) == pytest.approx(2.0)
    assert harness.reader('codec_device_ms.stream').read(t) == pytest.approx(1.0)
    assert harness.reader('step_mfu.stream').read(t) == pytest.approx(
        100 * w['step_min_s'] * 2 / 0.01)
    assert harness.reader('k5_roofline.stream').read(t) is None
    empty = TraceSummary(0.01, [], {}, {}, {}, {'units': 2}, w)
    assert harness.reader('step_mfu.stream').read(empty) is None


def test_peaks_are_the_data_sheet():
    with open(counts.PEAKS_FILE) as f:
        pk = json.load(f)
    assert (pk['bf16_tflops'], pk['f32_tflops'], pk['hbm_tb_per_s']) == (989.0, 67.0, 3.35)
