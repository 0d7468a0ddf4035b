"""The scan codecs of container impl id 7 (direct, cached, ring), the
wavefront schedules, the interleaved reverse encoder and the native rANS
runtime: port vs port, vs kernel 2's plain version and vs the JAX package
(its XLA scans, jitted on the CPU). One intra-op thread, small latents.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import cached as jcached
from imgcomp_cvpr_tpu.coding import codec as jcodec
from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu.coding import ring as jring
from imgcomp_cvpr_tpu.coding import wavefront as jwave
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import cached as tcached
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import planar as tplanar
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.coding import ring as tring
from imgcomp_cvpr_tpu_torch.coding import scan_codec as sc
from imgcomp_cvpr_tpu_torch.coding import wavefront as twave
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

SCHED_SHAPES = [(3, 5, 5), (4, 6, 7), (16, 24, 36)]
TWINS = ('direct', 'cached', 'ring')


def _fields_equal(mine, ref):
    assert type(mine).__name__ == type(ref).__name__
    assert mine._fields == ref._fields
    for name in mine._fields:
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(b, tuple) and b and hasattr(b, '_fields'):
            _fields_equal(a, b)
        elif isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(x, y, err_msg=name)
        elif isinstance(b, tuple) and b and hasattr(b[0], '_fields'):
            for x, y in zip(a, b, strict=True):
                _fields_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize('mode', ['asap', 'linear'])
@pytest.mark.parametrize('cs', [9, 5])
@pytest.mark.parametrize('shape', SCHED_SHAPES)
def test_wavefront_schedule_equals_jax(shape, cs, mode):
    _fields_equal(twave.build_schedule(shape, cs, mode), jwave.build_schedule(shape, cs, mode))


@pytest.mark.parametrize('shape', SCHED_SHAPES)
def test_cached_and_ring_schedules_equal_jax(shape):
    _fields_equal(tcached.build_cached_schedule(shape), jcached.build_cached_schedule(shape))
    _fields_equal(tring.build_ring_schedule(shape), jring.build_ring_schedule(shape))


# ---------------------------------------------------------------------------
# The three twins against each other and against kernel 2's plain version
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(shape, seed=4, kf=8, L=6, spec='cvpr/res_shallow'):
    """The same context model in both packages (K=3 unless ``spec`` says
    otherwise): the port's seeded init with small random biases, carried
    into JAX params (weights.pc_tree)."""
    del shape                       # one model serves every latent shape
    tcfg = tconfig.parse_spec(spec, 'pc')[0].replace(arch_param__k=kf)
    tm = tpc.init_params(tpc.ProbClassifier(tcfg, L, device='cpu'), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in (tm.net.conv0, tm.net.res1.conv1, tm.net.res1.conv2, tm.net.conv_out):
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g) * 0.1)
    cfg = jconfig.parse_spec(spec, 'pc')[0].replace(arch_param__k=kf)
    params = {'params': jax.tree_util.tree_map(jnp.asarray, tweights.pc_tree(
        {n: t.detach() for n, t in tm.state_dict().items()}))}
    centers = np.linspace(-2.0, 2.0, L).astype(np.float32)
    return jpc.ProbClassifier(cfg, L), cfg, params, tm, tcfg, centers


def _syms(b, shape, seed=0):
    return np.random.RandomState(seed).randint(0, 6, (b,) + shape).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _twin_streams(shape, b):
    _, _, _, tm, tcfg, centers = _models(shape)
    syms = _syms(b, shape)
    return {impl: tcodec.LatentCodec(tm, tcfg, device='cpu', impl=impl).encode_batch(syms, centers)
            for impl in TWINS}


@pytest.mark.parametrize('b', [1, 3])
@pytest.mark.parametrize('shape', [(3, 5, 5), (4, 6, 7)])
def test_twins_write_identical_containers_and_cross_decode(shape, b):
    _, _, _, tm, tcfg, centers = _models(shape)
    syms = _syms(b, shape)
    streams = _twin_streams(shape, b)
    ref = [r.bitstream for r in streams['direct']]
    for impl in TWINS:
        assert [r.bitstream for r in streams[impl]] == ref, impl
        assert all(tcodec.stream_impl_id(s) == tcodec.IMPL_WAVEFRONT for s in ref)
        assert [r.theoretical_bits for r in streams[impl]] == [
            r.theoretical_bits for r in streams['direct']]
    for impl in TWINS:   # each decodes the (shared) streams of the others
        dec = tcodec.LatentCodec(tm, tcfg, device='cpu', impl=impl).decode_batch(
            ref, centers, device_out=False)
        np.testing.assert_array_equal(dec, syms.astype(np.int32), err_msg=impl)


@pytest.mark.parametrize('impl', TWINS)
@pytest.mark.parametrize('shape', [(3, 5, 5), (4, 6, 7)])
def test_twin_tables_equal_kernel2_plain(shape, impl):
    """Per-cell (freq, start) of the teacher-forced scan: equal, every entry,
    to wavefront_encode_plain's (0 flips)."""
    _, _, _, tm, tcfg, centers = _models(shape)
    syms = _syms(3, shape, seed=1)
    n = int(np.prod(shape))
    f, s, sched = sc.ScanCoder(tm, tcfg, 'cpu', impl).encode_tables(syms, centers)
    idx = np.where(sched.active, sched.sym_flat, n)
    w = tcc.fold_weights(tm, torch.from_numpy(centers))
    kf, ks = ck.wavefront_encode_plain(w, shape, torch.from_numpy(syms.reshape(3, -1)).int())
    kidx = ck.build_schedule(shape).idx_cm
    assert torch.equal(sc.cell_tables(f, idx, n), sc.cell_tables(kf.long(), kidx, n))
    assert torch.equal(sc.cell_tables(s, idx, n), sc.cell_tables(ks.long(), kidx, n))


# ---------------------------------------------------------------------------
# Against the JAX package's XLA scans
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_scan_tables(impl, b, shape, **model):
    jm, cfg, params, _, _, centers = _models(shape, **model)
    syms = _syms(b, shape, seed=2)
    lc = jcodec.LatentCodec(jm, cfg, impl=impl)
    run, sched = lc._batched_scan_fn(shape)
    r = jrans.R_LANES if sched.M >= jrans.R_LANES else sched.M
    _, fsel, ssel, _ = run(params, jnp.asarray(centers), jnp.asarray(syms.reshape(b, -1)),
                           jnp.zeros((b, sched.T * sched.M), jnp.uint32),
                           jnp.full((b, r), jrans.RANS_L, jnp.uint32), jnp.int32(1),
                           jnp.full((b, r), np.iinfo(np.int32).max // 2, jnp.int32))
    return syms, np.asarray(fsel), np.asarray(ssel), sched


@pytest.mark.parametrize('impl', TWINS)
@pytest.mark.parametrize('shape', [(3, 5, 5), (4, 6, 7)])
def test_twin_tables_match_jax_scans(shape, impl):
    """The form of test_plain_forward_tables_match_pallas's bound: every
    mismatch a CDF boundary flip (|delta| <= 2), and at most 2 of them (or
    0.1% of the entries where that is more). XLA sums a layer in another
    order than the port's layer sum, so a logit differs by an ulp now and
    then; measured: 2, 1, 0 flips of 150 (direct, ring, cached) at
    (3, 5, 5), 1, 0, 0 of 336 at (4, 6, 7)."""
    syms, jf, js, jsched = _jax_scan_tables(impl, 2, shape)
    _, _, _, tm, tcfg, centers = _models(shape)
    f, s, sched = sc.ScanCoder(tm, tcfg, 'cpu', impl).encode_tables(syms, centers)
    np.testing.assert_array_equal(sched.active, np.asarray(jsched.active))
    f, s = f.numpy(), s.numpy()
    flips = ((f != jf) | (s != js)) & sched.active[None]
    assert np.abs(f - jf.astype(np.int64))[flips].max(initial=0) <= 2
    assert np.abs(s - js.astype(np.int64))[flips].max(initial=0) <= 2
    limit = max(2, int(1e-3 * sched.active.sum() * 2))
    assert flips.sum() <= limit, (flips.sum(), sched.active.sum() * 2)


K5 = dict(shape=(4, 8, 8), seed=6, kf=4, spec='base')    # pc base: kernel_size 5


@functools.lru_cache(maxsize=None)
def _k5_direct_tables(b=2):
    """The port's direct scan at K=5 (teacher-forced) on b seeded volumes."""
    shape = K5['shape']
    _, _, _, tm, tcfg, centers = _models(**K5)
    assert tcfg.kernel_size == 5
    syms = _syms(b, shape, seed=2)
    f, s, sched = sc.ScanCoder(tm, tcfg, 'cpu', 'direct').encode_tables(syms, centers)
    return syms, f, s, sched


@pytest.mark.parametrize('ref', ['jax_direct', 'kernel5_plain'])
def test_direct_k5_tables_match_jax_direct_and_kernel5_plain(ref):
    """direct at K=5 (pc base, (4, 8, 8)): its per-cell (freq, start) against
    JAX's direct scan (a wrong tap order, skip index or all-pad constant
    would show here, though a round trip would not) and against kernel 5's
    plain version (the planar codec's tables, mapped to cells). The bound
    of test_twin_tables_match_jax_scans: every mismatch a CDF boundary flip
    (|delta| <= 2), at most max(2, 0.1%) of the entries; measured 0 flips of
    512 against either."""
    shape = K5['shape']
    n = int(np.prod(shape))
    syms, f, s, sched = _k5_direct_tables()
    b = syms.shape[0]
    if ref == 'jax_direct':
        _, rf, rs, jsched = _jax_scan_tables('direct', b, **K5)
        np.testing.assert_array_equal(sched.active, np.asarray(jsched.active))
        got, want, live = (f.numpy(), s.numpy()), (rf, rs), sched.active[None]
    else:
        _, _, _, tm, tcfg, centers = _models(**K5)
        coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
        _, fold = coder._prepare(shape, torch.from_numpy(centers))
        kf, ks = coder.encode_tables(torch.from_numpy(syms).int(), fold, plain=True)
        C, H, W = shape
        pidx = np.asarray(tplanar.build_planar_schedule(shape, 5).idx_cm, np.int64)
        kidx = np.concatenate([np.where(pidx < H * W, pidx + d * H * W, n) for d in range(C)])
        idx = np.where(sched.active, sched.sym_flat, n)
        got = tuple(sc.cell_tables(t, idx, n).numpy() for t in (f, s))
        want = tuple(sc.cell_tables(t.long(), kidx, n).numpy() for t in (kf, ks))
        live = np.ones((1, n), bool)
    flips = ((got[0] != want[0]) | (got[1] != want[1])) & live
    for g, w in zip(got, want):
        assert np.abs(g - w.astype(np.int64))[flips].max(initial=0) <= 2
    entries = int(live.sum()) * b
    assert entries == b * n
    assert flips.sum() <= max(2, int(1e-3 * entries)), (flips.sum(), entries)


def test_theory_bits_near_jax_direct_k5():
    """At K=5 too (pc base, (4, 8, 8)): the theoretical bits of the port's
    direct codec within 1e-4 (relative) of the JAX direct codec's."""
    jm, cfg, params, tm, tcfg, centers = _models(**K5)
    syms = _syms(2, K5['shape'], seed=3)
    mine = tcodec.LatentCodec(tm, tcfg, device='cpu', impl='direct').encode_batch(syms, centers)
    ref = jcodec.LatentCodec(jm, cfg, impl='direct').encode_batch(params, syms, centers)
    assert all(tcodec.stream_impl_id(r.bitstream) == tcodec.IMPL_WAVEFRONT for r in mine)
    for a, b in zip(mine, ref, strict=True):
        assert abs(a.theoretical_bits - b.theoretical_bits) <= 1e-4 * b.theoretical_bits


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
@pytest.mark.parametrize('shape', [(4, 6, 7), (16, 24, 36)])
def test_interleaved_reverse_equals_jax(shape, x0):
    """Given the same (T, M) tables, the port's interleaved reverse encoder
    writes JAX's encode_reverse_scan_interleaved words, count, states and
    warmups (M = 39 at (16, 24, 36): one 39-lane sub-iteration)."""
    sched = jwave.build_schedule(shape, 9)
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(6), size=(2, sched.T, sched.M)).astype(np.float32)
    freq, cdf = trans.quantize_cdf(torch.from_numpy(probs))
    sym = torch.from_numpy(rng.randint(0, 6, (2, sched.T, sched.M, 1)))
    fs = torch.gather(freq, -1, sym)[..., 0] * torch.from_numpy(sched.active)
    ss = torch.gather(cdf, -1, sym)[..., 0] * torch.from_numpy(sched.active)
    words, n, st, k = trans.encode_reverse_scan_interleaved(
        fs, ss, torch.from_numpy(sched.active), x0)
    for i in range(2):
        jw, jn, jst, jk = jrans.encode_reverse_scan_interleaved(
            jnp.asarray(fs[i].numpy(), jnp.uint32), jnp.asarray(ss[i].numpy(), jnp.uint32),
            jnp.asarray(sched.active), x0=x0)
        assert int(n[i]) == int(jn)
        np.testing.assert_array_equal(words[i].numpy(), np.asarray(jw).astype(np.int64))
        np.testing.assert_array_equal(st[i].numpy(), np.asarray(jst).astype(np.int64))
        np.testing.assert_array_equal(k[i].numpy(), np.asarray(jk))


@pytest.mark.parametrize('x0', [1, trans.RANS_L])
def test_native_reverse_equals_numpy(x0):
    """The g++-built runtime writes the numpy loop's bytes (and JAX's)."""
    rng = np.random.RandomState(11)
    T, M = 60, 7
    probs = rng.dirichlet(np.ones(6), size=(T, M)).astype(np.float32)
    f, c = (a.numpy() for a in trans.quantize_cdf(torch.from_numpy(probs)))
    syms = rng.randint(0, 6, (T, M, 1))
    fs = np.take_along_axis(f, syms, -1)[..., 0].astype(np.uint32)
    ss = np.take_along_axis(c, syms, -1)[..., 0].astype(np.uint32)
    act = rng.rand(T, M) < 0.85
    nat = trans.encode_reverse(fs, ss, act, x0)
    plain = trans.encode_reverse(fs, ss, act, x0, native=False)
    ref = jrans.vectorized_encode(fs, ss, act, x0)
    for got in (nat, plain):
        for u, v in zip(got[0], ref[0], strict=True):
            np.testing.assert_array_equal(u, v)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])


def test_theory_bits_near_jax_direct_and_jax_rejects_id7():
    """Theoretical bits within 1e-4 (relative) of the JAX direct codec's on
    the same model and symbols; the JAX LatentCodec refuses an id-7 stream
    instead of decoding it as one of its own."""
    shape = (4, 6, 7)
    jm, cfg, params, tm, tcfg, centers = _models(shape)
    syms = _syms(3, shape, seed=3)
    mine = tcodec.LatentCodec(tm, tcfg, device='cpu', impl='direct').encode_batch(syms, centers)
    ref = jcodec.LatentCodec(jm, cfg, impl='direct').encode_batch(params, syms, centers)
    for a, b in zip(mine, ref, strict=True):
        assert abs(a.theoretical_bits - b.theoretical_bits) <= 1e-4 * b.theoretical_bits
    with pytest.raises(KeyError):
        jcodec.LatentCodec(jm, cfg, impl='direct').decode_batch(
            params, [mine[0].bitstream], centers)


def test_direct_k5_round_trip_and_routing():
    """direct at K=5 (4, 8, 8) round-trips bit-exactly; cached / ring at
    K=5 become the planar codec (id 6); id 7 routes to the codec's own scan,
    else to direct; ids 0-4 are refused."""
    cfg, _ = tconfig.parse_spec('base', 'pc')
    cfg = cfg.replace(arch_param__k=4)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, 6, device='cpu'), seed=6)
    centers = np.linspace(-2.0, 2.0, 6).astype(np.float32)
    syms = _syms(1, (4, 8, 8), seed=4)[0]
    lc = tcodec.LatentCodec(pc, cfg, device='cpu', impl='direct')
    res = lc.roundtrip(syms, centers)
    assert tcodec.stream_impl_id(res.bitstream) == tcodec.IMPL_WAVEFRONT
    assert tcodec.LatentCodec(pc, cfg, device='cpu').coder(7).impl == 'direct'
    for impl in ('cached', 'ring', 'cuda'):
        assert tcodec.LatentCodec(pc, cfg, device='cpu', impl=impl).impl_id == 6
    _, _, _, tm, tcfg, _ = _models((3, 5, 5))
    assert tcodec.LatentCodec(tm, tcfg, device='cpu').coder(7).impl == 'direct'
    assert tcodec.LatentCodec(tm, tcfg, device='cpu', impl='cached').coder(7).impl == 'cached'
    for impl in range(5):
        with pytest.raises(ValueError, match='not decodable'):
            lc.coder(impl)
    with pytest.raises(ValueError, match='unknown impl'):
        tcodec.LatentCodec(pc, cfg, device='cpu', impl='pallas')


@pytest.mark.parametrize('impl', TWINS)
def test_ab_streams_dump_and_cross_with_scan_impls(tmp_path, impl):
    """ab_streams --impl accepts the three scans: dump twice, compare, cross."""
    from imgcomp_cvpr_tpu_torch.tools import ab_streams
    args = ['--cpu', 'dump', '--shape', '3', '5', '5', '--batch', '2',
            '--impl', impl]
    a, b = str(tmp_path / 'a.pkl'), str(tmp_path / 'b.pkl')
    assert ab_streams.main(args + ['--out', a]) == 0
    assert ab_streams.main(args + ['--out', b]) == 0
    assert ab_streams.main(['--cpu', 'compare', a, b]) == 0
    assert ab_streams.main(['--cpu', 'cross', a]) == 0
