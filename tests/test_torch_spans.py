"""The port's spans (utils/spans.py) on the CPU: free and unrecorded with no
profiler; under torch.profiler kept in memory with their nesting, on the
profiler's clock; and recorded where the codec, the AE, the training step
and validation put them, with the bias-row counter of the planar codec."""

import contextlib
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.eval import validate as tvalidate
from imgcomp_cvpr_tpu_torch.models import autoencoder as tae
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.ops.kernels import build
from imgcomp_cvpr_tpu_torch.training import trainer as ttrainer
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from imgcomp_cvpr_tpu_torch.utils import spans

L = 6
CENTERS = np.linspace(-2.0, 2.0, L).astype(np.float32)
VAL_STEPS = {'val.upload', 'val.ae_encode', 'val.ae_decode', 'val.bitcost', 'val.msssim',
             'val.psnr', 'val.to_host'}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@contextlib.contextmanager
def recorded(out):
    """Run the block under a CPU torch.profiler; ``out`` gets the spans
    it recorded (what an earlier session left is dropped first) and the
    profiler."""
    spans.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield
    out['spans'] = spans.take()
    out['prof'] = prof


def _names(sp):
    return Counter(n for n, *_ in sp)


def _tiny_ae_pc(K=3):
    ae, _ = tconfig.parse_spec('cvpr/low', 'ae')
    pc, _ = tconfig.parse_spec('cvpr/res_shallow' if K == 3 else 'base', 'pc')
    return (ae.replace(arch_param_B=1, num_chan_bn=4, batch_size=2, crop_size=(32, 32),
                       distortion_to_minimize='mse'),
            pc.replace(arch_param__k=4))


def test_off_is_the_shared_null_context_and_records_nothing():
    spans.take()
    a, b = spans.span('a'), spans.span('b')
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:
            pass
    assert spans.take() == []


def test_spans_nest_and_share_the_profilers_clock():
    got = {}
    x = torch.ones(64, 64)
    with recorded(got):
        for _ in range(3):
            with spans.span('outer'):
                with spans.span('inner'):
                    x = x @ x / 64
    sp = got['spans']
    assert _names(sp) == {'outer': 3, 'inner': 3}
    outer = sorted(s for s in sp if s[0] == 'outer')
    inner = sorted(s for s in sp if s[0] == 'inner')
    for o, i in zip(outer, inner):
        assert (o[3], i[3]) == (0, 1)
        assert o[1] <= i[1] <= i[2] <= o[2]
    events = defaultdict(list)
    for e in got['prof'].profiler.kineto_results.events():
        if e.name().startswith(spans.PREFIX):
            events[e.name()[len(spans.PREFIX):]].append(e.start_ns())
    for name, rows in (('outer', outer), ('inner', inner)):
        assert len(events[name]) == len(rows)
        for ev, row in zip(sorted(events[name]), rows):
            assert abs(ev - row[1]) < 1_000_000


def test_take_returns_one_session_and_clears():
    first, second = {}, {}
    with recorded(first):
        with spans.span('one'):
            pass
    assert _names(first['spans']) == {'one': 1} and spans.take() == []
    with recorded(second):
        with spans.span('two'):
            pass
    assert _names(second['spans']) == {'two': 1}


def _round_trip(coder, syms):
    centers = torch.from_numpy(CENTERS)
    res = coder.encode_batch(syms, centers)
    dec = coder.decode_batch([r.bitstream for r in res], centers, device_out=False)
    np.testing.assert_array_equal(dec, syms)


def test_planar_round_trip_spans_and_bias_row_count():
    """K=5, B=2, latent (4, 8, 8): 4 bias-row calls in encode (one a level)
    and C in decode (one a plane), each in its own span; on the CPU the
    plain versions run and the kernel's launch counter stays put."""
    _, cfg = _tiny_ae_pc(5)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), 0)
    coder = tpcodec.PlanarCoder(pc, cfg, device='cpu')
    B, C = 2, 4
    syms = np.random.RandomState(0).randint(0, L, (B, C, 8, 8)).astype(np.int32)
    before = build.LAUNCHES['bias_rows']
    got = {}
    with recorded(got):
        _round_trip(coder, syms)
    assert build.LAUNCHES['bias_rows'] == before
    n = _names(got['spans'])
    assert n['planar.bias_rows'] == 4 + C
    assert n['codec.serialize'] == 1 and n['codec.parse'] == 2 and n['codec.wait'] == 2


def test_wavefront_round_trip_spans_have_no_bias_rows():
    _, cfg = _tiny_ae_pc(3)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), 0)
    coder = tcc.CudaCoder(pc, cfg, device='cpu')
    syms = np.random.RandomState(1).randint(0, L, (1, 2, 4, 6)).astype(np.int32)
    before = build.LAUNCHES['bias_rows']
    got = {}
    with recorded(got):
        _round_trip(coder, syms)
    assert build.LAUNCHES['bias_rows'] == before
    n = _names(got['spans'])
    assert 'planar.bias_rows' not in n
    assert n['codec.serialize'] == 1 and n['codec.parse'] == 2 and n['codec.wait'] == 2


def test_train_step_records_its_phases_in_order():
    ae_cfg, pc_cfg = _tiny_ae_pc()
    trainer = ttrainer.Trainer(ae_cfg, pc_cfg, num_train_images=64, device='cpu')
    state = trainer.init_state(0)
    batch = (np.random.RandomState(0).rand(2, 32, 32, 3) * 255).astype(np.uint8)
    got = {}
    with recorded(got):
        trainer.train_step(state, batch)
    phases = [n for n, *_ in sorted(got['spans'], key=lambda s: s[1])]
    assert phases == ['train.forward', 'train.backward', 'train.optimizer']
    assert all(d == 0 for *_, d in got['spans'])


def test_ae_encode_and_decode_are_spans():
    ae_cfg, _ = _tiny_ae_pc()
    ae = tae.init_params(tae.CVPRAutoencoder(ae_cfg, device='cpu'), 0)
    x = torch.rand(1, 32, 32, 3) * 255
    got = {}
    with recorded(got):
        ae.decode(ae.encode(x).qhard)
    assert _names(got['spans']) == {'ae.encode': 1, 'ae.decode': 1}


def test_validation_steps_are_spans():
    ae_cfg, pc_cfg = _tiny_ae_pc()
    em = tvalidate.EvalModel(ae_cfg, pc_cfg, device='cpu')
    tae.init_params(em.ae, 0)
    tpc.init_params(em.pc, 1)
    img = (np.random.RandomState(2).rand(32, 32, 3) * 255).astype(np.uint8)
    got = {}
    with recorded(got):
        em.fetch_many([img])
    n = _names(got['spans'])
    assert {k for k in n if k.startswith('val.')} == VAL_STEPS
    assert all(n[k] == 1 for k in VAL_STEPS)
    # the AE's own spans nest inside validate's
    depth = {name: d for name, _, _, d in got['spans']}
    assert depth['val.ae_encode'] == 0 and depth['ae.encode'] == 1
