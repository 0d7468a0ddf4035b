"""Port vs JAX package on non-finite logits and activations (CPU).

A column of logits that holds a NaN or a +inf has one CDF in the JAX
kernels (pallas_kernel.py's _quantize_cdf_kernel, which both TPU forward
kernels call): freq 1 for every symbol, cdf_low l, a column that sums to L
and not to SCALE. Kernel 2's f8 operands reach it: an activation past 464
rounds to NaN in the e4m3 ring, as XLA converts it, and jax.nn.relu keeps
the NaN. The port's plain versions (cuda_kernel.logits_to_cdf, torch.relu)
must give the same tables, and every rANS coder of the port must code such
a column. JAX runs make_forward(prec=...) in interpret mode, as its own
tests do; the port runs the plain PyTorch versions of kernels 2, 3, 5, 6.
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
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from test_torch_coding import _folded_from_jax, _setup, interleaved_decode, interleaved_encode
from test_torch_prec import _flips, _jax_enc_tables

SHAPE, L, B = (4, 6, 7), 6, 2
# Layer 1's output channel 6 of _setup's seed-2 model, times 300: some
# layer-1 activations pass 464, the last value that e4m3 does not round to
# NaN, and a minority of the columns go non-finite (33 of 336 at f8).
HOT_CHANNEL, HOT_SCALE = 6, 300.0


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


# ---------------------------------------------------------------------------
# The CDF of a column against _quantize_cdf_kernel
# ---------------------------------------------------------------------------

def _columns(L, seed=0):
    """Seeded (n, L) float32 logit columns: ordinary ones, all-equal ones, a
    NaN at each position, a +inf and a -inf at each position, a +inf beside
    a NaN, two +infs, and columns of NaN, +inf and -inf alone."""
    rng = np.random.RandomState(seed)
    base = (rng.randn(40, L) * 4).astype(np.float32)
    cols = [base, np.full((3, L), 1.5, np.float32), np.zeros((1, L), np.float32)]
    for v in (np.nan, np.inf, -np.inf):
        c = base[:L].copy()
        c[np.arange(L), np.arange(L)] = v
        cols += [c, np.full((1, L), v, np.float32)]
    c = base[:2].copy()
    c[0, :2] = (np.inf, np.nan)
    c[1, -2:] = np.inf
    cols.append(c)
    return np.concatenate(cols)


def _jax_cdf(logits: np.ndarray, L: int):
    f, c = jax.jit(lambda x: pk._quantize_cdf_kernel(x, L))(jnp.asarray(logits.T))
    return np.asarray(f).T, np.asarray(c).T


def _jax_probs(logits: np.ndarray) -> np.ndarray:
    """The first three lines of _quantize_cdf_kernel: its probabilities."""
    def probs(x):
        e = jnp.exp(x - jnp.max(x, axis=-1, keepdims=True))
        return e / jnp.sum(e, axis=-1, keepdims=True)
    return np.asarray(jax.jit(probs)(jnp.asarray(logits)))


@pytest.mark.parametrize('L', [6, 5])
def test_logits_to_cdf_matches_jax_kernel_on_nonfinite_columns(L):
    """logits_to_cdf equals the JAX kernel's CDF on every entry: a column
    with a NaN or a +inf is freq 1 everywhere with cdf_low l (sum L), a -inf
    only takes its symbol's probability to 0, and a column of -inf alone is
    NaN (-inf - -inf)."""
    cols = _columns(L)
    jf, jc = _jax_cdf(cols, L)
    tf, tc = ck.logits_to_cdf(torch.from_numpy(cols))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tc.numpy(), jc)
    bad = np.isnan(cols).any(-1) | np.isposinf(cols).any(-1) | np.isneginf(cols).all(-1)
    assert bad.sum() >= 2 * L + 4
    np.testing.assert_array_equal(jf[bad], np.ones((bad.sum(), L)))
    np.testing.assert_array_equal(jc[bad], np.broadcast_to(np.arange(L), (bad.sum(), L)))
    np.testing.assert_array_equal(jf.sum(-1), np.where(bad, L, trans.SCALE))


@pytest.mark.parametrize('L', [6, 5])
def test_quantize_cdf_of_nan_probs_matches_jax_kernel(L):
    """rans.quantize_cdf on the JAX kernel's own probabilities (NaN columns
    included) gives the kernel's tables: floor(NaN) converts to 0, as XLA
    converts it, not to torch's INT64_MIN on the CPU."""
    cols = _columns(L, seed=1)
    probs = _jax_probs(cols)
    assert np.isnan(probs).any(-1).sum() >= 2 * L + 2
    tf, tc = trans.quantize_cdf(torch.from_numpy(probs))
    jf, jc = _jax_cdf(cols, L)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_logits_to_cdf_and_jax_xla_softmax_cdf_part_on_a_nan_column():
    """An accepted difference (ROADMAP Queue 1): the port's codecs take
    their tables from logits_to_cdf, which follows the JAX kernel; the JAX
    package's XLA impls take theirs from rans.quantize_cdf over
    jax.nn.softmax, whose argmax hands the deficit to the first NaN. Only
    non-finite weights reach it. A finite column gives both the same table."""
    nan = np.full((1, 3), np.nan, np.float32)
    tf, tc = ck.logits_to_cdf(torch.from_numpy(nan))
    jf, jc = jax.jit(lambda x: jrans.quantize_cdf(jax.nn.softmax(x, axis=-1)))(jnp.asarray(nan))
    np.testing.assert_array_equal(tf.numpy(), [[1, 1, 1]])
    np.testing.assert_array_equal(tc.numpy(), [[0, 1, 2]])
    np.testing.assert_array_equal(np.asarray(jf), [[trans.SCALE - 2, 1, 1]])
    np.testing.assert_array_equal(np.asarray(jc), [[0, trans.SCALE - 2, trans.SCALE - 1]])
    flat = np.zeros((1, 3), np.float32)
    jf, jc = jax.jit(lambda x: jrans.quantize_cdf(jax.nn.softmax(x, axis=-1)))(jnp.asarray(flat))
    tf, tc = ck.logits_to_cdf(torch.from_numpy(flat))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize('x0', [1, trans.RANS_L])
def test_rans_coders_take_columns_summing_to_L(x0):
    """Tables drawn from columns that sum to L (freq 1, start = symbol) among
    ordinary ones: the interleaved reverse sub-iterations (the plain
    version of kernels 3 and 6) write JAX's encode_reverse_scan_interleaved
    words, states and warmups, and the interleaved decode sub-iterations
    (slot = start for freq 1) recover the symbols."""
    rng = np.random.RandomState(5)
    T, M = 80, 5
    logits = (rng.randn(T, M, L) * 3).astype(np.float32)
    logits[rng.rand(T, M) < 0.3, rng.randint(0, L)] = np.nan
    f, c = ck.logits_to_cdf(torch.from_numpy(logits))
    assert (f.sum(-1) == L).sum() > 50 and (f.sum(-1) == trans.SCALE).sum() > 200
    syms = torch.from_numpy(rng.randint(0, L, (T, M, 1)))
    fs = torch.gather(f.long(), -1, syms)[None, ..., 0]
    ss = torch.gather(c.long(), -1, syms)[None, ..., 0]
    act = np.ones((T, M), bool)
    enc = interleaved_encode(fs, ss, act, x0)
    words, n, st, k = enc
    jw, jn, jst, jk = jrans.encode_reverse_scan_interleaved(
        jnp.asarray(fs[0].numpy(), jnp.uint32), jnp.asarray(ss[0].numpy(), jnp.uint32),
        jnp.asarray(act), x0=x0)
    assert int(n[0]) == int(jn)
    np.testing.assert_array_equal(words[0].numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(jst).astype(np.int64))
    np.testing.assert_array_equal(k[0].numpy(), np.asarray(jk))
    got, _ = interleaved_decode(enc, f.long()[None], c.long()[None], act)
    np.testing.assert_array_equal(got[0].numpy(), syms[..., 0].numpy())


# ---------------------------------------------------------------------------
# Kernel 2 at f8 on a model whose layer-1 activations pass 464
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def hot():
    """_setup's seed-2 K=3 model with layer 1's channel HOT_CHANNEL scaled
    by HOT_SCALE in both packages, seeded symbols, and a cache of JAX's
    interpret-mode results by precision."""
    jm, cfg, params, tm, tcfg, centers = _setup(SHAPE, seed=2)
    w = np.array(params['params']['conv0']['w'])
    b = np.array(params['params']['conv0']['b'])
    w[..., HOT_CHANNEL] *= HOT_SCALE
    b[HOT_CHANNEL] *= HOT_SCALE
    params = {'params': dict(params['params'], conv0={'w': jnp.asarray(w), 'b': jnp.asarray(b)})}
    tm.load_state_dict(tweights.pc_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    syms = np.random.RandomState(2).randint(0, L, (B,) + SHAPE).astype(np.int8)
    return dict(jm=jm, cfg=cfg, params=params, tm=tm, tcfg=tcfg, centers=centers,
                syms=syms, jax={})


def _jax_tables(hot, prec):
    key = 'tables', prec
    if key not in hot['jax']:
        hot['jax'][key] = _jax_enc_tables(hot['jm'], hot['cfg'], hot['params'], hot['centers'],
                                          hot['syms'], prec)
    return hot['jax'][key]


def _cells_to_tables(values: np.ndarray, fill=0) -> np.ndarray:
    """(B, n) per-cell values -> (B, T, CQ) in the tables' layout."""
    idx = ck.build_schedule(SHAPE).idx_cm
    act = idx < np.prod(SHAPE)
    out = np.full((values.shape[0],) + idx.shape, fill, values.dtype)
    out[:, act] = values[:, idx[act]]
    return out


def _sum_l_entries(f, s, syms_t, act):
    """Entries whose column provably sums to L, not SCALE: the last symbol
    with freq 1 at start L - 1 (a column summing to SCALE ends at SCALE)."""
    return (f == 1) & (s == L - 1) & (syms_t == L - 1) & act[None]


def test_hot_model_passes_the_e4m3_range(hot):
    """The case is driven: layer 1 at float32 passes 464 on some cells but
    not on most, and JAX's f8 tables hold columns that sum to L."""
    weights, jf, js = _jax_tables(hot, 'f8')
    fw = _folded_from_jax(weights, 8)
    tabs = ck.device_tables(SHAPE, 'cpu')
    q = torch.from_numpy(hot['syms'].reshape(B, -1)).long()
    src = torch.cat([fw.centers[q], fw.pad.expand(B, 1)], 1)[:, :, None]
    y1 = torch.relu(ck.layer_all_cells(src, tabs.taps[0].long(), fw.w1, fw.b1))
    hot_cells = (y1 > 464).any(-1)
    assert 0 < int(hot_cells.sum()) < hot_cells.numel() // 4
    act = ck.build_schedule(SHAPE).idx_cm < np.prod(SHAPE)
    syms_t = _cells_to_tables(hot['syms'].reshape(B, -1).astype(np.int32))
    assert _sum_l_entries(jf, js, syms_t, act).sum() >= 1


@pytest.mark.parametrize('prec', ['f8', 'bf16'])
def test_plain_tables_match_jax_on_the_hot_model(hot, prec):
    """The plain layer-parallel encode, the step-ordered plain version and
    the wrapper's CPU path against JAX's make_forward(prec, interpret=True):
    at f8 every non-finite column (the port's logits say which) is JAX's
    table exactly, freq 1 at start = symbol; elsewhere _flips' bound. bf16's
    range holds the activations: no non-finite logit."""
    weights, jf, js = _jax_tables(hot, prec)
    fw = _folded_from_jax(weights, 8)
    true_syms = torch.from_numpy(hot['syms'].reshape(B, -1))
    (tf, ts), logits = ck.wavefront_encode_plain(fw, SHAPE, true_syms, prec=prec,
                                                 return_logits=True)
    bad = _cells_to_tables((~torch.isfinite(logits)).any(-1).numpy(), False)
    syms_t = _cells_to_tables(hot['syms'].reshape(B, -1).astype(np.int32))
    tf, ts = tf.numpy(), ts.numpy()
    if prec == 'f8':
        assert bad.sum() >= 10
        np.testing.assert_array_equal(tf[bad], jf[bad])
        np.testing.assert_array_equal(ts[bad], js[bad])
        np.testing.assert_array_equal(tf[bad], 1)
        np.testing.assert_array_equal(ts[bad], syms_t[bad])
    else:
        assert not bad.any()
    assert _flips(tf, ts, jf, js, SHAPE) <= 2
    sf, ss = ck.wavefront_forward_plain(ck.MODE_ENCODE, fw, SHAPE, true_syms=true_syms,
                                        prec=ck.prec_id(prec))
    wf, ws = ck.wavefront_forward(ck.MODE_ENCODE, fw, SHAPE, true_syms=true_syms, prec=prec)
    for f, s in ((sf, ss), (wf, ws)):
        np.testing.assert_array_equal(f.numpy(), tf)
        np.testing.assert_array_equal(s.numpy(), ts)


@pytest.mark.parametrize('prec', ['f8', 'bf16'])
def test_plain_decode_of_jax_streams_on_the_hot_model(hot, prec, monkeypatch):
    """JAX's streams of the hot model (its encode kernel, its make_reverse)
    round-trip through JAX, and the port's plain dec_only decode reads them
    to JAX's dec_only symbols."""
    monkeypatch.setenv('IMGCOMP_PALLAS_PREC', prec)
    coder = PallasCoder(hot['jm'], hot['cfg'])
    res = coder.encode_batch(hot['params'], hot['syms'], hot['centers'])
    streams = [r.bitstream for r in res]
    assert {jcodec.stream_prec(s) for s in streams} == {ck.prec_id(prec)}
    jdec = coder.decode_batch(hot['params'], streams, hot['centers'])
    np.testing.assert_array_equal(jdec, hot['syms'].astype(np.int32))
    sched = ck.build_schedule(SHAPE)
    words = np.zeros((B, sched.stream_cap), np.int32)
    states = np.zeros((B, ck.R), np.int64)
    thresh = np.zeros((B, ck.R), np.int32)
    for i, s in enumerate(streams):
        _, w, st, _, k = jcodec.deserialize_stream(s)
        words[i, :len(w)] = w
        states[i] = st
        thresh[i] = tcc._NO_THRESH if k is None else ck.lane_totals(sched) - k
    fw = _folded_from_jax(coder._weights(hot['params'], jnp.asarray(hot['centers'])), 8)
    dec = ck.wavefront_forward_plain(ck.MODE_DECODE, fw, SHAPE, streams=torch.from_numpy(words),
                                     init_states=torch.from_numpy(states),
                                     thresh=torch.from_numpy(thresh), prec=ck.prec_id(prec))
    np.testing.assert_array_equal(dec.numpy().reshape(jdec.shape), jdec)


def test_codec_round_trips_the_hot_model_at_f8(hot):
    """The port's CPU LatentCodec(prec='f8') round-trips the hot model
    bit-exactly (kernels 2 and 3's plain versions on columns that sum to L),
    with JAX's theoretical bits (float32 there) to 1e-6."""
    lc = tcodec.LatentCodec(hot['tm'], hot['tcfg'], device='cpu', prec='f8')
    res = lc.encode_batch(hot['syms'], hot['centers'])
    assert {tcodec.stream_prec(r.bitstream) for r in res} == {2}
    dec = lc.decode_batch([r.bitstream for r in res], hot['centers'], device_out=False)
    np.testing.assert_array_equal(dec, hot['syms'].astype(np.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('IMGCOMP_PALLAS_PREC', 'f8')
        jres = PallasCoder(hot['jm'], hot['cfg']).encode_batch(hot['params'], hot['syms'],
                                                               hot['centers'])
    for r, j in zip(res, jres):
        assert abs(r.theoretical_bits - j.theoretical_bits) <= 1e-6 * j.theoretical_bits


# ---------------------------------------------------------------------------
# Kernel 5 (K=5, prec 0) on a model with a +inf logit
# ---------------------------------------------------------------------------

def test_k5_plain_codec_on_an_inf_logit():
    """A seeded K=5 context model whose last layer is scaled (in float64,
    once) until its largest logits pass float32's range: +inf logits, so
    NaN columns through inf - inf. Kernel 5's plain layer-parallel tables
    equal its plain scan's on every entry, each non-finite column codes its
    symbol at freq 1, start = symbol, and the CPU codec round-trips."""
    shape = (4, 8, 8)
    cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(kernel_size=5, arch_param__k=8)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), seed=1)
    centers = torch.linspace(-2.0, 2.0, L)
    syms = torch.from_numpy(np.random.RandomState(1).randint(0, L, (B,) + shape)).int()
    coder = tpcodec.PlanarCoder(pc, cfg, device='cpu')
    _, logits = coder.encode_tables(syms, coder._prepare(shape, centers)[1], return_logits=True)
    scale = 1.25 * float(np.finfo(np.float32).max) / float(logits.max())
    with torch.no_grad():
        for t in (pc.net.conv_out.weight, pc.net.conv_out.bias):
            t.copy_((t.double() * scale).float())
    coder = tpcodec.PlanarCoder(pc, cfg, device='cpu')
    fold = coder._prepare(shape, centers)[1]
    (tf, ts), logits = coder.encode_tables(syms, fold, return_logits=True)
    assert (logits == float('inf')).any()
    fq, _ = ck.logits_to_cdf(logits)
    ones = (fq == 1).all(-1)
    assert 0 < int(ones.sum()) < ones.numel() // 4
    sf, ss = coder.encode_tables_scan(syms, fold)
    assert torch.equal(sf, tf) and torch.equal(ss, ts)
    lc = tcodec.LatentCodec(pc, cfg, device='cpu')
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers)
    assert torch.equal(dec.int(), syms)
    # The same images' bits where the columns are finite: the +inf cells
    # cost 16 bits a symbol (freq 1 of 2^16).
    assert all(r.theoretical_bits >= 16 * int(ones.reshape(B, -1).sum(1)[i])
               for i, r in enumerate(res))
