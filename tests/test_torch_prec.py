"""Port vs JAX package: kernel 2's operand precisions bf16 and f8 (the
container's prec byte 1 and 2) on the CPU.

JAX runs make_forward(prec=...) in interpret mode, as its own tests do; the
port runs the plain PyTorch versions of kernel 2 (CPU tensors) and its codec
through them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import codec as jcodec
from imgcomp_cvpr_tpu.coding import pallas_kernel as pk
from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu.coding.pallas_codec import PallasCoder
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from test_torch_coding import _folded_from_jax, _setup

PRECS = ('bf16', 'f8')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---------------------------------------------------------------------------
# round_operand against XLA's converts
# ---------------------------------------------------------------------------

def _xla(x: np.ndarray, dtype) -> np.ndarray:
    return np.asarray(jax.jit(lambda a: a.astype(dtype).astype(jnp.float32))(jnp.asarray(x)))


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))))


def test_round_operand_matches_xla_converts():
    """e4m3fn: round to nearest even with subnormals, NaN on overflow (XLA
    does not saturate; torch's own cast does, which round_operand repairs);
    bf16: round to nearest even, ties included."""
    edges = np.array([460, 470, -1000, 0.0013, 1e-9, 448, 464, 464.0001, -464.0001,
                      np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)
    out = ck.round_operand(torch.from_numpy(edges), 'e4m3').numpy()
    np.testing.assert_array_equal(out[:7], [448, np.nan, np.nan, 0.001953125, 0, 448, 448])
    assert _same(out, _xla(edges, jnp.float8_e4m3fn))
    # e4m3 subnormals (multiples of 2^-9 below 2^-6) and the ties between them.
    sub = (np.arange(0, 17, dtype=np.float32) * np.float32(2.0 ** -10))
    assert _same(ck.round_operand(torch.from_numpy(sub), 'e4m3').numpy(),
                 _xla(sub, jnp.float8_e4m3fn))
    # bf16 ties to even: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6.
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 1 + 2 ** -8 + 2 ** -20,
                     3.0e38, np.inf, np.nan], np.float32)
    got = ck.round_operand(torch.from_numpy(ties), 'bf16').numpy()
    np.testing.assert_array_equal(got[:4], [1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -7])
    assert _same(got, _xla(ties, jnp.bfloat16))
    # A sweep over seven decades of magnitude, both signs.
    rng = np.random.RandomState(0)
    x = (rng.randn(200000) * 10.0 ** rng.uniform(-5, 3, 200000)).astype(np.float32)
    for kind, dtype in (('bf16', jnp.bfloat16), ('e4m3', jnp.float8_e4m3fn)):
        assert _same(ck.round_operand(torch.from_numpy(x), kind).numpy(), _xla(x, dtype))
    assert torch.equal(ck.round_operand(torch.from_numpy(x), None), torch.from_numpy(x))
    with pytest.raises(ValueError):
        ck.round_operand(torch.from_numpy(x), 'fp16')


def test_prec_ids():
    assert [ck.prec_id(p) for p in ('f32', 'bf16', 'f8', 0, 1, 2)] == [0, 1, 2, 0, 1, 2]
    for bad in ('fp8', 3, -1, True, None):
        with pytest.raises(ValueError):
            ck.prec_id(bad)


# ---------------------------------------------------------------------------
# The plain versions' tables against JAX make_forward(prec=...)
# ---------------------------------------------------------------------------

def _jax_enc_tables(jm, cfg, params, centers, syms, prec):
    """JAX interpret-mode enc_parallel forward at ``prec`` -> (its folded
    weights, fsel, ssel (B, T, CQ))."""
    b, shape = syms.shape[0], syms.shape[1:]
    coder = PallasCoder(jm, cfg)
    tables, sched = coder._tables(shape, 1)
    pack_true = coder._prep_fns(shape, b, 1)[0]
    weights = coder._weights(params, jnp.asarray(centers))
    fwd, _ = pk.make_forward(shape, cfg.arch_param__k, jm.num_centers, b, bsub=1,
                             prec=prec, enc_parallel=True, interpret=True)
    _, fsel, ssel = fwd(weights, tables, pack_true(jnp.asarray(syms.reshape(b, -1))),
                        jnp.zeros((1, 1, 128), jnp.uint32),
                        jnp.full((b, 1, pk.R), jrans.RANS_L, jnp.uint32),
                        jnp.ones((1,), jnp.int32))
    return weights, np.array(fsel)[:, :sched.T, 0], np.array(ssel)[:, :sched.T, 0]


def _flips(tf, ts, jf, js, shape):
    act = ck.build_schedule(shape).idx_cm < np.prod(shape)
    flips = ((tf != jf) | (ts != js)) & act[None]
    assert np.abs(tf - jf)[flips].max(initial=0) <= 2
    assert np.abs(ts - js)[flips].max(initial=0) <= 2
    assert not tf[:, ~act].any() and not ts[:, ~act].any()
    return int(flips.sum())


# Flips measured against XLA:CPU: 0 at (4, 6, 7) for both precisions; at
# (8, 12, 16) 0 for bf16 and 2 of 3072 entries for f8. A product of bf16
# values is exact in float32, so what is left is the order of the float32
# sums (XLA's dot against the port's (tap, channel) chain), the source of the
# flips that the precision-0 tests accept (test_torch_coding.py: at most 2).
@pytest.mark.parametrize('shape', [(4, 6, 7), (8, 12, 16)])
@pytest.mark.parametrize('prec', PRECS)
def test_plain_tables_match_jax_make_forward(prec, shape):
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=2)
    syms = np.random.RandomState(2).randint(0, 6, (2,) + shape)
    weights, jf, js = _jax_enc_tables(jm, cfg, params, centers, syms, prec)
    fw = _folded_from_jax(weights, 8)
    true_syms = torch.from_numpy(syms.reshape(2, -1))
    tf, ts = ck.wavefront_encode_plain(fw, shape, true_syms, prec=prec)
    assert _flips(tf.numpy(), ts.numpy(), jf, js, shape) <= 2
    # The step-ordered plain version and the wrapper's CPU path give the
    # layer-at-a-time tables exactly, and they are not precision 0's.
    sf, ss = ck.wavefront_forward_plain(ck.MODE_ENCODE, fw, shape, true_syms=true_syms,
                                        prec=ck.prec_id(prec))
    assert torch.equal(sf, tf) and torch.equal(ss, ts)
    wf, ws = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=true_syms, prec=prec)
    assert torch.equal(wf, tf) and torch.equal(ws, ts)
    f0, _ = ck.wavefront_encode_plain(fw, shape, true_syms)
    assert not torch.equal(f0, tf)


def _encode_rounded_skip(fw, shape, true_syms, prec):
    """wavefront_encode_plain with the likely bug: layer 3's skip read from
    layer 1 rounded to the ring's type (the stored, rounded layer)."""
    sched = ck.build_schedule(shape)
    tabs = ck.device_tables(shape, 'cpu')
    w, ring = ck.operand_weights(fw, prec), ck.RING_KIND[ck.prec_id(prec)]
    B = true_syms.shape[0]
    src = torch.cat([w.centers[true_syms.long()], w.pad.expand(B, 1)], 1)[:, :, None]
    layer_w = ((w.w1, w.b1), (w.w2, w.b2), (w.w3, w.b3), (w.w4, w.b4))
    for li in range(4):
        y = ck.layer_all_cells(src, tabs.taps[li].long(), *layer_w[li], ring if li else None)
        if li == 2:
            y = y + ck.round_operand(act1[:, tabs.skip.long()], ring)
        else:
            y = torch.relu(y)
        if li == 3:
            logits = torch.empty_like(y)
            logits[:, tabs.cells[3].long()] = y
            break
        src = torch.empty(B, sched.layers[li].G + 1, y.shape[-1])
        src[:, -1] = (w.k1, w.k2, w.k3)[li]
        src[:, tabs.cells[li].long()] = y
        if li == 0:
            act1 = src
    return ck.tables_from_logits(logits, tabs.idx_cm.long(), true_syms)


@pytest.mark.parametrize('prec', PRECS)
def test_layer3_skip_reads_float32(prec):
    """A plain version whose skip reads layer 1 rounded gives other tables,
    far from JAX's; the port's (float32 skip) stays within the bound."""
    shape = (4, 6, 7)
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=2)
    syms = np.random.RandomState(2).randint(0, 6, (2,) + shape)
    weights, jf, js = _jax_enc_tables(jm, cfg, params, centers, syms, prec)
    fw = _folded_from_jax(weights, 8)
    true_syms = torch.from_numpy(syms.reshape(2, -1))
    tf, ts = ck.wavefront_encode_plain(fw, shape, true_syms, prec=prec)
    bf, bs = _encode_rounded_skip(fw, shape, true_syms, prec)
    act = ck.build_schedule(shape).idx_cm < np.prod(shape)
    wrong = int((((bf.numpy() != jf) | (bs.numpy() != js)) & act[None]).sum())
    right = int((((tf.numpy() != jf) | (ts.numpy() != js)) & act[None]).sum())
    assert right <= 2 and wrong > 10 * max(right, 1), (right, wrong)


# ---------------------------------------------------------------------------
# Decode (make_forward(dec_only=True)) and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('prec', PRECS)
def test_plain_decode_matches_jax_dec_only(prec, monkeypatch):
    """The JAX codec's prec-1 / prec-2 streams (its encode kernel, its
    make_reverse) decode through the port's plain decode at that precision
    to the symbols that JAX's dec_only variant decodes, which are the
    teacher symbols."""
    shape = (4, 6, 7)
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=2)
    syms = np.random.RandomState(2).randint(0, 6, (2,) + shape).astype(np.int8)
    monkeypatch.setenv('IMGCOMP_PALLAS_PREC', prec)
    coder = PallasCoder(jm, cfg)
    res = coder.encode_batch(params, syms, centers)
    streams = [r.bitstream for r in res]
    assert {jcodec.stream_prec(s) for s in streams} == {ck.prec_id(prec)}
    jdec = coder.decode_batch(params, streams, centers)
    np.testing.assert_array_equal(jdec, syms.astype(np.int32))
    sched = ck.build_schedule(shape)
    words = np.zeros((2, sched.stream_cap), np.int32)
    states = np.zeros((2, ck.R), np.int64)
    thresh = np.zeros((2, ck.R), np.int32)
    for i, s in enumerate(streams):
        _, w, st, _, k = jcodec.deserialize_stream(s)
        words[i, :len(w)] = w
        states[i] = st
        thresh[i] = tcc._NO_THRESH if k is None else ck.lane_totals(sched) - k
    fw = _folded_from_jax(coder._weights(params, jnp.asarray(centers)), 8)
    dec = ck.wavefront_forward_plain(ck.MODE_DECODE, fw, shape, streams=torch.from_numpy(words),
                                     init_states=torch.from_numpy(states),
                                     thresh=torch.from_numpy(thresh), prec=ck.prec_id(prec))
    np.testing.assert_array_equal(dec.numpy().reshape(jdec.shape), jdec)


@pytest.fixture(scope='module')
def k3_model():
    shape = (4, 6, 7)
    _, _, _, tm, tcfg, centers = _setup(shape, seed=4)
    syms = np.random.RandomState(4).randint(0, 6, (2,) + shape).astype(np.int8)
    return tm, tcfg, centers, syms


def test_round_trip_at_each_precision(k3_model):
    """Each precision round-trips bit-exactly on the plain path, writes its
    prec byte, and a coder of another precision decodes it (decode routes on
    the stream's byte). The streams of the three precisions differ, and the
    f32 streams are those of a coder given no precision."""
    tm, tcfg, centers, syms = k3_model
    out = {}
    for prec in ('f32', 'bf16', 'f8'):
        lc = tcodec.LatentCodec(tm, tcfg, device='cpu', prec=prec)
        res = lc.encode_batch(syms, centers)
        assert {tcodec.stream_prec(r.bitstream) for r in res} == {ck.prec_id(prec)}
        assert {tcodec.stream_impl_id(r.bitstream) for r in res} == {tcodec.IMPL_CUDA}
        out[prec] = [r.bitstream for r in res]
        dec = lc.decode_batch(out[prec], centers, device_out=False)
        np.testing.assert_array_equal(dec, syms.astype(np.int32))
    other = tcodec.LatentCodec(tm, tcfg, device='cpu', prec='f32')
    for prec in ('bf16', 'f8'):
        np.testing.assert_array_equal(other.decode_batch(out[prec], centers, device_out=False),
                                      syms.astype(np.int32))
    assert len({tuple(v) for v in out.values()}) == 3
    assert [r.bitstream for r in tcodec.LatentCodec(tm, tcfg, device='cpu').encode_batch(
        syms, centers)] == out['f32']


def test_mixed_precision_batch_raises(k3_model):
    tm, tcfg, centers, syms = k3_model
    a = tcodec.LatentCodec(tm, tcfg, device='cpu', prec='f32').encode(syms[0], centers)
    b = tcodec.LatentCodec(tm, tcfg, device='cpu', prec='bf16').encode(syms[1], centers)
    with pytest.raises(ValueError, match='mixed stream precisions'):
        tcodec.LatentCodec(tm, tcfg, device='cpu').decode_batch([a.bitstream, b.bitstream],
                                                                centers)


def test_env_precision_honoured(k3_model, monkeypatch):
    """prec=None reads IMGCOMP_PALLAS_PREC at each encode, as the JAX
    package's PallasCoder does; an explicit prec wins; an unknown value
    raises."""
    tm, tcfg, centers, syms = k3_model
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    assert tcodec.stream_prec(lc.encode(syms[0], centers).bitstream) == 0
    monkeypatch.setenv('IMGCOMP_PALLAS_PREC', 'f8')
    assert tcodec.stream_prec(lc.encode(syms[0], centers).bitstream) == 2
    explicit = tcodec.LatentCodec(tm, tcfg, device='cpu', prec='bf16')
    assert tcodec.stream_prec(explicit.encode(syms[0], centers).bitstream) == 1
    monkeypatch.setenv('IMGCOMP_PALLAS_PREC', 'fp8')
    with pytest.raises(ValueError, match='IMGCOMP_PALLAS_PREC'):
        lc.encode(syms[0], centers)
    with pytest.raises(ValueError):
        tcodec.LatentCodec(tm, tcfg, device='cpu', prec='fp16')


def test_fold_cache_keys_on_precision(k3_model):
    """One coder, three precisions: each gets its operands (the bf16 ones
    are operand_weights of the float32 fold), each is folded once."""
    tm, tcfg, centers, syms = k3_model
    coder = tcc.CudaCoder(tm, tcfg, device='cpu')
    f0 = coder._prepare(syms.shape[1:], centers, 0)[1]
    f1 = coder._prepare(syms.shape[1:], centers, 1)[1]
    f2 = coder._prepare(syms.shape[1:], centers, 2)[1]
    assert coder._prepare(syms.shape[1:], centers, 1)[1] is f1
    assert coder._prepare(syms.shape[1:], centers)[1] is f0
    for a, b in zip(f1, ck.operand_weights(f0, 'bf16')):
        assert torch.equal(a, b)
    assert not torch.equal(f0.w2, f1.w2) and torch.equal(f1.w2, f2.w2)
    assert torch.equal(f0.b2, f1.b2)                       # biases stay float32
    assert not torch.equal(f1.k2, f2.k2)                   # the ring's type
    assert torch.equal(f2.k2, ck.round_operand(f0.k2, 'e4m3'))


def test_planar_streams_refuse_nonzero_precision():
    """Impl id 6 (planar) writes precision 0 only, as the JAX package's
    planar codec does: its streams with a nonzero prec byte are refused
    with a clear error, and the codec refuses another precision."""
    L = 6
    centers = np.linspace(-2.0, 2.0, L).astype(np.float32)
    impl, shape = 'cuda_planar', (4, 8, 8)
    cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(kernel_size=5, arch_param__k=8)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), seed=1)
    syms = np.random.RandomState(1).randint(0, L, (1,) + shape).astype(np.int8)
    lc = tcodec.LatentCodec(pc, cfg, device='cpu', impl=impl)
    stream = lc.encode_batch(syms, centers)[0].bitstream
    assert tcodec.stream_prec(stream) == 0
    assert tcodec.stream_impl_id(stream) == tcodec.IMPL_IDS[impl]
    for p in (1, 2):
        bad = bytearray(stream)
        bad[2] = (bad[2] & ~0x3) | p
        with pytest.raises(ValueError, match=f'container precision {p}'):
            lc.decode_batch([bytes(bad)], centers)
    with pytest.raises(ValueError, match='precision 0'):
        tcodec.LatentCodec(pc, cfg, device='cpu', impl=impl, prec='bf16')


def test_tools_honour_env_precision(tmp_path, monkeypatch):
    """ab_streams and profile_codec go through the codec, which reads
    IMGCOMP_PALLAS_PREC: a dump records the precision and its streams carry
    the prec byte; profile_codec reports it."""
    import pickle
    from imgcomp_cvpr_tpu_torch.tools import ab_streams, profile_codec
    monkeypatch.setenv('IMGCOMP_PALLAS_PREC', 'f8')
    out = str(tmp_path / 'f8.pkl')
    assert ab_streams.main(['--cpu', 'dump', '--shape', '3', '4', '5', '--batch', '2',
                            '--out', out]) == 0
    with open(out, 'rb') as f:
        d = pickle.load(f)
    assert d['prec'] == 2
    assert {tcodec.stream_prec(s) for s in d['cases'][1]['streams']} == {2}
    assert d['cases'][1]['digest'] == ab_streams.digest(d['cases'][1]['streams'])
    r = profile_codec.profile(batch=1, h=16, w=24, iters=1, device='cpu')
    assert r['prec'] == 'f8'
