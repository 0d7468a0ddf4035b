"""The served codecs (container impl ids 5 and 6) against the JAX package's
XLA scans (jitted on the CPU): kernel 2's and kernel 5's plain tables
against JAX's direct / cached / ring scans, theoretical bits against JAX's
direct codec, the routing of every container impl id, and the interleaved
rANS sub-iterations against JAX's interleaved coder. One intra-op thread,
small latents.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import codec as jcodec
from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu.coding import wavefront as jwave
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import planar as tplanar
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig
from test_torch_coding import interleaved_decode, interleaved_encode

torch.set_num_threads(1)

SCAN_IMPLS = ('direct', 'cached', 'ring')     # the JAX package's XLA scans
K3_SHAPES = [(3, 5, 5), (4, 6, 7), (16, 24, 36)]
K5 = dict(shape=(4, 8, 8), seed=6, kf=4, spec='base')    # pc base: kernel_size 5


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


def _cell_tables(fsel: torch.Tensor, index: np.ndarray, n: int) -> np.ndarray:
    """(B, rows, cols) per-lane tables and the (rows, cols) latent index of
    each lane (>= n on dead lanes) -> (B, n) per-cell tables."""
    idx = torch.from_numpy(np.asarray(index, np.int64).reshape(-1))
    live = idx < n
    out = torch.zeros(fsel.shape[0], n, dtype=torch.long)
    out[:, idx[live]] = fsel.reshape(fsel.shape[0], -1).long()[:, live]
    return out.numpy()


def _assert_flips_bounded(got, want):
    """The form of test_plain_forward_tables_match_pallas's bound on (freq,
    start) per cell: every mismatch a CDF boundary flip (|delta| <= 2), and
    at most 2 of them (or 0.1% of the entries where that is more)."""
    flips = (got[0] != want[0]) | (got[1] != want[1])
    for g, w in zip(got, want):
        assert np.abs(g - w)[flips].max(initial=0) <= 2
    assert flips.sum() <= max(2, int(1e-3 * flips.size)), (flips.sum(), flips.size)


@functools.lru_cache(maxsize=None)
def _jax_scan_tables(impl, b, shape, **model):
    """JAX's teacher-forced XLA scan ``impl`` on b seeded volumes: (symbols,
    per-cell freq, per-cell start)."""
    jm, cfg, params, _, _, centers = _models(shape, **model)
    syms = _syms(b, shape, seed=2)
    lc = jcodec.LatentCodec(jm, cfg, impl=impl)
    run, sched = lc._batched_scan_fn(shape)
    r = jrans.R_LANES if sched.M >= jrans.R_LANES else sched.M
    _, fsel, ssel, _ = run(params, jnp.asarray(centers), jnp.asarray(syms.reshape(b, -1)),
                           jnp.zeros((b, sched.T * sched.M), jnp.uint32),
                           jnp.full((b, r), jrans.RANS_L, jnp.uint32), jnp.int32(1),
                           jnp.full((b, r), np.iinfo(np.int32).max // 2, jnp.int32))
    n = int(np.prod(shape))
    idx = np.where(sched.active, sched.sym_flat, n)
    return syms, tuple(_cell_tables(torch.from_numpy(np.asarray(t).astype(np.int64)), idx, n)
                       for t in (fsel, ssel))


@pytest.mark.parametrize('impl', SCAN_IMPLS)
@pytest.mark.parametrize('shape', [(3, 5, 5), (4, 6, 7)])
def test_kernel2_plain_tables_match_jax_scans(shape, impl):
    """Kernel 2's plain tables (wavefront_encode_plain, mapped to cells)
    against each of JAX's XLA scans, under _assert_flips_bounded: XLA sums a
    layer in another order than the port's layer sum, so a logit differs by
    an ulp now and then (measured: 2, 1, 0 flips of 150 against direct,
    ring, cached at (3, 5, 5), 1, 0, 0 of 336 at (4, 6, 7)). Not at
    (16, 24, 36): there JAX's own scans break this bound against one
    another (direct against cached and ring: 27 and 26 flips of 27,648
    entries, |delta| up to 4), and kernel 2's plain tables are 33, 30 and
    31 flips from direct, cached and ring."""
    syms, want = _jax_scan_tables(impl, 2, shape)
    _, _, _, tm, _, centers = _models(shape)
    w = tcc.fold_weights(tm, torch.from_numpy(centers))
    kf, ks = ck.wavefront_encode_plain(w, shape, torch.from_numpy(syms.reshape(2, -1)).int())
    n = int(np.prod(shape))
    kidx = ck.build_schedule(shape).idx_cm
    _assert_flips_bounded(tuple(_cell_tables(t, kidx, n) for t in (kf, ks)), want)


def test_kernel5_plain_tables_match_jax_direct_k5():
    """Kernel 5's plain tables (PlanarCoder.encode_tables(plain=True), mapped
    to cells) at K=5 (pc base, (4, 8, 8)) against JAX's direct scan: a wrong
    tap order, skip index or all-pad constant would show here, though a
    round trip would not. The bound of _assert_flips_bounded; measured 0
    flips of 512."""
    shape = K5['shape']
    n = int(np.prod(shape))
    syms, want = _jax_scan_tables('direct', 2, **K5)
    _, _, _, tm, tcfg, centers = _models(**K5)
    assert tcfg.kernel_size == 5
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    _, fold = coder._prepare(shape, torch.from_numpy(centers))
    kf, ks = coder.encode_tables(torch.from_numpy(syms).int(), fold, plain=True)
    C, H, W = shape
    pidx = np.asarray(tplanar.build_planar_schedule(shape, 5).idx_cm, np.int64)
    kidx = np.concatenate([np.where(pidx < H * W, pidx + d * H * W, n) for d in range(C)])
    _assert_flips_bounded(tuple(_cell_tables(t, kidx, n) for t in (kf, ks)), want)


@pytest.mark.parametrize('shape,b', [(s, b) for s in K3_SHAPES for b in (1, 3)]
                         + [(K5['shape'], b) for b in (1, 2)])
def test_theory_bits_near_jax_direct(shape, b):
    """The served codec's theoretical bits (id 5 at K=3, id 6 at K=5 with pc
    base) within 1e-4 (relative) of the JAX direct codec's on the same
    model and symbols; the JAX LatentCodec refuses the port's stream
    instead of decoding it as one of its own."""
    model = K5 if shape == K5['shape'] else dict(shape=shape)
    jm, cfg, params, tm, tcfg, centers = _models(**model)
    syms = _syms(b, shape, seed=3)
    mine = tcodec.LatentCodec(tm, tcfg, device='cpu').encode_batch(syms, centers)
    ref = jcodec.LatentCodec(jm, cfg, impl='direct').encode_batch(params, syms, centers)
    served = tcodec.IMPL_CUDA if tcfg.kernel_size == 3 else tcodec.IMPL_CUDA_PLANAR
    assert all(tcodec.stream_impl_id(r.bitstream) == served for r in mine)
    for a, r in zip(mine, ref, strict=True):
        assert abs(a.theoretical_bits - r.theoretical_bits) <= 1e-4 * r.theoretical_bits
    with pytest.raises(KeyError):
        jcodec.LatentCodec(jm, cfg, impl='direct').decode_batch(
            params, [mine[0].bitstream], centers)


@functools.lru_cache(maxsize=None)
def _routing_model(K):
    cfg, _ = tconfig.parse_spec('base' if K == 5 else 'cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=4)
    pc = tpc.init_params(tpc.ProbClassifier(cfg, 6, device='cpu'), seed=6)
    centers = np.linspace(-2.0, 2.0, 6).astype(np.float32)
    shape = (4, 8, 8) if K == 5 else (3, 5, 5)
    return pc, cfg, centers, _syms(1, shape, seed=4)


@pytest.mark.parametrize('impl_id', range(8))
@pytest.mark.parametrize('K', [3, 5])
def test_codec_routes_each_impl_id(K, impl_id):
    """A codec at K=3 (id 5) or K=5 (id 6) routes a stream on its container
    impl id: ids 0-4 (the JAX package's) and 7 (the port's retired scan
    codecs) are refused as not decodable before the payload is parsed (the
    stream here is a header alone); id 5 reaches the K=3 codec, which
    refuses K=5; id 6 reaches the planar codec at either K. 'cuda' off K=3
    is the planar codec; no other impl name is taken."""
    pc, cfg, centers, syms = _routing_model(K)
    lc = tcodec.LatentCodec(pc, cfg, device='cpu')
    served = tcodec.IMPL_CUDA if K == 3 else tcodec.IMPL_CUDA_PLANAR
    assert lc.impl_id == served
    assert tcodec.LatentCodec(pc, cfg, device='cpu', impl='cuda').impl_id == served
    for impl in ('direct', 'cached', 'ring', 'pallas'):
        with pytest.raises(ValueError, match='unknown impl'):
            tcodec.LatentCodec(pc, cfg, device='cpu', impl=impl)
    if impl_id not in (tcodec.IMPL_CUDA, tcodec.IMPL_CUDA_PLANAR):
        head = tcodec.MAGIC + bytes([tcodec.VERSION | impl_id << 4])
        assert tcodec.stream_impl_id(head) == impl_id
        with pytest.raises(ValueError, match='not decodable'):
            lc.decode_batch([head], centers)
        return
    if impl_id == tcodec.IMPL_CUDA and K == 5:
        with pytest.raises(ValueError, match='requires kernel_size 3'):
            lc.coder(impl_id)
        return
    writer = tcodec.LatentCodec(pc, cfg, device='cpu', impl=tcodec.IMPL_NAMES[impl_id])
    streams = [r.bitstream for r in writer.encode_batch(syms, centers)]
    assert tcodec.stream_impl_id(streams[0]) == impl_id
    coder = lc.coder(impl_id)
    assert type(coder) is (tcc.CudaCoder if impl_id == tcodec.IMPL_CUDA
                           else tpcodec.PlanarCoder)
    np.testing.assert_array_equal(lc.decode_batch(streams, centers, device_out=False),
                                  syms.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _interleaved_case(shape, x0):
    """Seeded tables over JAX's linear wavefront schedule (M = 39 lanes a
    step at (16, 24, 36): one 39-lane sub-iteration), B = 2, and the port's
    interleaved encode of them."""
    sched = jwave.build_schedule(shape, 9)
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(6), size=(2, sched.T, sched.M)).astype(np.float32)
    freq, cdf = trans.quantize_cdf(torch.from_numpy(probs))
    sym = torch.from_numpy(rng.randint(0, 6, (2, sched.T, sched.M, 1)))
    act = torch.from_numpy(sched.active)
    fs = torch.gather(freq, -1, sym)[..., 0] * act
    ss = torch.gather(cdf, -1, sym)[..., 0] * act
    return (sched, freq, cdf, sym[..., 0] * act, fs, ss,
            interleaved_encode(fs, ss, sched.active, x0))


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
@pytest.mark.parametrize('shape', [(4, 6, 7), (16, 24, 36)])
def test_interleaved_reverse_equals_jax(shape, x0):
    """Given the same (T, M) tables, rans.encode_reverse_step_interleaved
    driven over the schedule writes JAX's encode_reverse_scan_interleaved
    words, count, states and warmups."""
    sched, _, _, _, fs, ss, (words, n, st, k) = _interleaved_case(shape, x0)
    for i in range(2):
        jw, jn, jst, jk = jrans.encode_reverse_scan_interleaved(
            jnp.asarray(fs[i].numpy(), jnp.uint32), jnp.asarray(ss[i].numpy(), jnp.uint32),
            jnp.asarray(sched.active), x0=x0)
        assert int(n[i]) == int(jn)
        np.testing.assert_array_equal(words[i].numpy(), np.asarray(jw).astype(np.int64))
        np.testing.assert_array_equal(st[i].numpy(), np.asarray(jst).astype(np.int64))
        np.testing.assert_array_equal(k[i].numpy(), np.asarray(jk))


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
@pytest.mark.parametrize('shape', [(4, 6, 7), (16, 24, 36)])
def test_interleaved_decode_recovers_symbols_and_matches_jax(shape, x0):
    """rans.decode_step_interleaved over those words recovers the symbols,
    and its states, read pointer and counts equal JAX's
    decode_step_interleaved after every step (with thresh = total - k, the
    tail packing's stop)."""
    sched, freq, cdf, sym, _, _, enc = _interleaved_case(shape, x0)
    got, after = interleaved_decode(enc, freq, cdf, sched.active)
    np.testing.assert_array_equal(got.numpy(), sym.numpy())
    words, n, st, k = enc
    r = st.shape[1]
    thresh = sched.active.reshape(sched.T, -1, r).sum((0, 1)) - k.numpy()
    step = jax.jit(jrans.decode_step_interleaved)
    for i in range(2):
        stream = jnp.asarray(words[i, :int(n[i])].flip(0).numpy().astype(np.uint32))
        js, jg = jnp.asarray(st[i].numpy().astype(np.uint32)), jnp.int32(0)
        jc, jt = jnp.zeros(r, jnp.int32), jnp.asarray(thresh[i].astype(np.int32))
        for t in range(sched.T):
            jsym, js, jg, jc = step(js, jg, stream, jnp.asarray(freq[i, t].numpy(), jnp.uint32),
                                    jnp.asarray(cdf[i, t].numpy(), jnp.uint32),
                                    jnp.asarray(sched.active[t]), jc, jt)
            np.testing.assert_array_equal(np.asarray(jsym), got[i, t].numpy())
            states, gptr, cnt = after[t]
            np.testing.assert_array_equal(np.asarray(js).astype(np.int64), states[i].numpy())
            assert int(jg) == int(gptr[i])
            np.testing.assert_array_equal(np.asarray(jc), cnt[i].numpy())
