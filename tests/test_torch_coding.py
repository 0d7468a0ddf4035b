"""Port vs JAX package: wavefront schedule, encode-mode tables, reverse rANS,
container, checksum and the whole K=3 codec slice (CPU).

JAX runs its Pallas kernels in interpret mode, as its own tests do; the port
runs the plain PyTorch versions of its CUDA kernels (a CPU tensor).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import codec as jcodec
from imgcomp_cvpr_tpu.coding import pallas_kernel as pk
from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu.coding.pallas_codec import PallasCoder
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

SHAPES = [(4, 6, 7), (3, 5, 5), (9, 5, 6)]


def _setup(shape, kf=8, L=6, seed=0):
    """The same random context model in both packages (the JAX init mapped
    through weights.pc_state_dict) and numpy-made symbols."""
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=kf)
    jm = jpc.ProbClassifier(cfg, L)
    params = jm.init(jax.random.PRNGKey(seed + 1), (1, shape[1], shape[2], shape[0]))
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tcfg = tcfg.replace(arch_param__k=kf)
    tm = tpc.ProbClassifier(tcfg, L, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    centers = np.linspace(-2.0, 2.0, L).astype(np.float32)
    return jm, cfg, params, tm, tcfg, centers


def _jax_tables(jm, cfg, params, centers, syms, x0=None):
    """JAX interpret-mode enc_parallel forward -> (weights, tables, fsel,
    ssel) with the tables trimmed to (B, T, CQ)."""
    b, shape = syms.shape[0], syms.shape[1:]
    coder = PallasCoder(jm, cfg)
    tables, sched = coder._tables(shape, 1)
    pack_true = coder._prep_fns(shape, b, 1)[0]
    weights = coder._weights(params, jnp.asarray(centers))
    fwd, _ = pk.make_forward(shape, cfg.arch_param__k, jm.num_centers, b, bsub=1,
                             prec='f32', enc_parallel=True, interpret=True)
    _, fsel, ssel = fwd(weights, tables, pack_true(jnp.asarray(syms.reshape(b, -1))),
                        jnp.zeros((1, 1, 128), jnp.uint32),
                        jnp.full((b, 1, pk.R), jrans.RANS_L, jnp.uint32),
                        jnp.ones((1,), jnp.int32))
    T = sched.T
    return (weights, tables, np.array(fsel)[:, :T, 0], np.array(ssel)[:, :T, 0],
            fsel, ssel)


def _folded_from_jax(weights, kf):
    pad, w1e, b1, w2, b2, w3, b3, w4, b4, k1, k2, k3, c = [
        torch.from_numpy(np.array(a)) for a in weights]
    return ck.FoldedWeights(
        w1e[::pk.Q_CH].reshape(-1, 1, kf), b1[:, 0], w2.reshape(-1, kf, kf), b2[:, 0],
        w3.reshape(-1, kf, kf), b3[:, 0], w4.reshape(-1, kf, w4.shape[-1]), b4[:, 0],
        k1[:, 0], k2[:, 0], k3[:, 0], pad, c[:, 0])


@pytest.mark.parametrize('shape', SHAPES + [(32, 8, 12)])
def test_schedule_matches_pallas(shape):
    ours = ck.build_schedule(shape)
    ref = pk.build_pallas_schedule(shape)
    assert (ours.T, ours.S, ours.CQ) == (ref.T, ref.S, ref.CQ)
    assert ours.chunk_offs == ref.chunk_offs
    np.testing.assert_array_equal(ours.idx_cm, ref.idx_cm[:ref.T])
    assert ours.stream_cap == pk.kernel_stream_rows(ref, 1) * 128
    assert ck._unmasked_taps(True) == pk._unmasked_taps(True)
    assert ck._unmasked_taps(False) == pk._unmasked_taps(False)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_logits_match_full_network(shape):
    """The wavefront's per-step cell order and pad semantics (constant rows,
    border cells, the L3 skip) reproduce ProbClassifier.logits on the whole
    padded volume."""
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=1)
    syms = np.random.RandomState(1).randint(0, 6, (2,) + shape)
    fw = tcc.fold_weights(tm, torch.from_numpy(centers))
    _, lg = ck.wavefront_forward_plain(ck.MODE_ENCODE, fw, shape,
                                       true_syms=torch.from_numpy(syms.reshape(2, -1)),
                                       return_logits=True)
    q = torch.from_numpy(centers[syms]).permute(0, 2, 3, 1)
    ref = tm.logits(q, float(centers[0])).detach()
    # Summation order differs (sequential taps vs conv3d): ~1e-6 relative.
    np.testing.assert_allclose(lg.reshape(ref.shape).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_tables_match_pallas(shape):
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=2)
    syms = np.random.RandomState(2).randint(0, 6, (2,) + shape)
    weights, _, jf, js, _, _ = _jax_tables(jm, cfg, params, centers, syms)
    # The port's weight folding and pad constants agree with the JAX fold.
    mine = tcc.fold_weights(tm, torch.from_numpy(centers))
    for a, b in zip(mine, _folded_from_jax(weights, 8)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    tf, ts = ck.wavefront_forward_plain(ck.MODE_ENCODE, _folded_from_jax(weights, 8),
                                        shape, true_syms=torch.from_numpy(syms.reshape(2, -1)))
    act = ck.build_schedule(shape).idx_cm < np.prod(shape)
    flips = ((tf.numpy() != jf) | (ts.numpy() != js)) & act[None]
    # XLA's and torch's CPU exp differ by an ulp on a share of f32 inputs,
    # and a 2^16 CDF scale turns an ulp of probability into a +-1 flip of a
    # floor() now and then. Every mismatch must be such a boundary flip
    # (|delta| <= 2 in freq and start). The count is held to 0.1% of the
    # entries, except at (4, 6, 7), where the 2 measured flips of 336
    # entries are an accepted library difference (ROADMAP Queue 3).
    assert np.abs(tf.numpy() - jf)[flips].max(initial=0) <= 2
    assert np.abs(ts.numpy() - js)[flips].max(initial=0) <= 2
    limit = 2 if shape == (4, 6, 7) else int(1e-3 * act.sum() * 2)
    assert flips.sum() <= limit, (flips.sum(), act.sum() * 2)


@functools.lru_cache(maxsize=None)
def _jax_reverse(shape, x0):
    """JAX interpret-mode tables of B=2 random symbol volumes and
    make_reverse's (words, n_words, states, k) on them, made once per
    (shape, x0) for the tests that hold the port's reverse encoders to it."""
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=3)
    b = 2
    syms = np.random.RandomState(3).randint(0, 6, (b,) + shape)
    _, tables, jf, js, jf_full, js_full = _jax_tables(jm, cfg, params, centers, syms)
    rev, _ = pk.make_reverse(shape, b, bsub=1, interpret=True, x0=x0)
    return b, jf, js, tuple(np.asarray(a) for a in rev(tables, jf_full, js_full))


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
@pytest.mark.parametrize('shape', [(4, 6, 7), (9, 5, 6)])
def test_plain_reverse_byte_identical_to_pallas(shape, x0):
    b, jf, js, (jw, jn, jst, jk) = _jax_reverse(shape, x0)
    tw, tn, tst, tk = ck.rans_reverse_plain(torch.from_numpy(jf), torch.from_numpy(js),
                                            shape, x0)
    np.testing.assert_array_equal(tn.numpy(), jn.reshape(b))
    for i in range(b):
        np.testing.assert_array_equal(tw[i, :tn[i]].numpy(), jw[i].reshape(-1)[:jn[i, 0, 0]])
    np.testing.assert_array_equal(tst.numpy().view(np.uint32), jst.reshape(b, pk.R))
    np.testing.assert_array_equal(tk.numpy(), jk.reshape(b, pk.R))
    # Per-lane oracle (rans.encode_reverse): each of the 32 lanes absorbs its
    # (step, sub-iteration) symbols in order — same final states, warmups
    # and word count.
    sched = ck.build_schedule(shape)
    S = sched.S
    act = (sched.idx_cm[:, :S * 32] < np.prod(shape)).reshape(-1, 32)
    for i in range(b):
        f = jf[i, :, :S * 32].reshape(-1, 32).astype(np.uint32)
        s = js[i, :, :S * 32].reshape(-1, 32).astype(np.uint32)
        streams, st, k = jrans.encode_reverse(f, s, act, x0=x0)
        np.testing.assert_array_equal(tst[i].numpy().view(np.uint32), st)
        np.testing.assert_array_equal(tk[i].numpy(), k)
        assert sum(len(w) for w in streams) == int(tn[i])


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
@pytest.mark.parametrize('shape', [(4, 6, 7), (9, 5, 6)])
def test_plain_list_walker_byte_identical_to_pallas(shape, x0):
    """The plain walker over the host-built list of non-empty
    sub-iterations (what kernel 3 runs) writes make_reverse's words, word
    counts, final states and warmups."""
    b, jf, js, (jw, jn, jst, jk) = _jax_reverse(shape, x0)
    sched = ck.build_schedule(shape)
    rows, masks = ck.reverse_list(sched.idx_cm < np.prod(shape))
    tw, tn, tst, tk = ck.reverse_plain_list(torch.from_numpy(jf), torch.from_numpy(js), rows,
                                            masks, sched.stream_cap, x0)
    np.testing.assert_array_equal(tn.numpy(), jn.reshape(b))
    for i in range(b):
        np.testing.assert_array_equal(tw[i, :tn[i]].numpy(), jw[i].reshape(-1)[:jn[i, 0, 0]])
    np.testing.assert_array_equal(tst.numpy().view(np.uint32), jst.reshape(b, pk.R))
    np.testing.assert_array_equal(tk.numpy(), jk.reshape(b, pk.R))


# (16, 24, 36): T = 526 steps of S = 4 sub-iterations; the Kodak latent
# (32, 64, 96): T = 1186, S = 12, of whose 14,232 sub-iterations 9,172 have an
# active lane (21.4 active lanes each on average).
@pytest.mark.parametrize('shape,count', [((16, 24, 36), 902), ((32, 64, 96), 9172)])
def test_reverse_list_is_the_active_sub_iterations(shape, count):
    """The list kernel 3 walks is {(t, si): active[t, si*32:(si+1)*32].any()}
    in reverse coding order, each with the exact lane mask."""
    sched = ck.build_schedule(shape)
    active = sched.idx_cm < np.prod(shape)
    rows, masks = ck.reverse_list(active)
    S = sched.CQ // ck.R
    want = [(t, si) for t in range(sched.T - 1, -1, -1) for si in range(S - 1, -1, -1)
            if active[t, si * ck.R:(si + 1) * ck.R].any()]
    assert len(rows) == len(want) == count
    assert list(zip((rows // S).tolist(), (rows % S).tolist())) == want
    assert rows.dtype == np.int32 and masks.dtype == np.uint32
    bits = np.unpackbits(masks.view(np.uint8), bitorder='little').reshape(-1, ck.R)
    np.testing.assert_array_equal(bits.astype(bool), active.reshape(-1, ck.R)[rows])


def test_reciprocal_division_is_exact():
    """The numpy twin of kernel 3's division by a reciprocal equals // and %
    (and its state update the update written with them) for every f in
    [1, 65536] at the boundary dividends f<<16 - 1, 2^32 - 1, 0, 1, f - 1,
    f, f + 1, for every dividend 0..f of f <= 2048, and on 10^6 random
    (x, f) pairs with x < f<<16 and 10^6 with any uint32 x."""
    mask = np.uint64(0xFFFFFFFF)
    f = np.arange(1, 65537, dtype=np.uint64)
    xs = [np.minimum((f << np.uint64(16)) - np.uint64(1), mask), np.full_like(f, mask)]
    xs += [f * np.uint64(0) + np.uint64(v) for v in (0, 1)]
    xs += [f - np.uint64(1), f, f + np.uint64(1)]
    cases = [(x, f) for x in xs]
    cases.append((np.concatenate([np.arange(v + 1) for v in range(1, 2049)]).astype(np.uint64),
                  np.concatenate([np.full(v + 1, v) for v in range(1, 2049)]).astype(np.uint64)))
    rng = np.random.RandomState(0)
    fr = rng.randint(1, 65537, 10 ** 6).astype(np.uint64)
    cases.append(((rng.randint(0, 1 << 62, 10 ** 6).astype(np.uint64) % (fr << np.uint64(16))), fr))
    cases.append((rng.randint(0, 1 << 32, 10 ** 6).astype(np.uint64), fr))
    for x, fv in cases:
        q, r = ck.rdiv_divmod(x, fv)
        np.testing.assert_array_equal(q, x // fv)
        np.testing.assert_array_equal(r, x % fv)
        s = (x * np.uint64(2654435761)) & np.uint64(0xFFFF)
        want = (((x // fv) << np.uint64(16)) + x % fv + s) & mask
        np.testing.assert_array_equal(ck.rdiv_update(x, fv, s), want)


@pytest.mark.parametrize('tail', [False, True])
@pytest.mark.parametrize('shape', [(4, 6, 7), (32, 64, 96), (5000, 3, 2)])
def test_container_byte_identical(shape, tail):
    rng = np.random.RandomState(4)
    words = rng.randint(0, 1 << 16, 300).astype(np.uint32)
    lo = 0 if tail else 1 << 16
    states = rng.randint(lo, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    k = rng.randint(0, 3000, 32).astype(np.int32) if tail else None
    crc = int(rng.randint(0, 1 << 31))
    ref = jcodec.serialize_stream(shape, words, states, crc, impl_id=tcodec.IMPL_CUDA,
                                  prec=0, k=k)
    ours = tcodec.serialize_stream(shape, words, states, crc,
                                   impl_id=tcodec.IMPL_CUDA, prec=0, k=k)
    assert ours == ref
    shp, w2, st2, crc2, k2 = tcodec.deserialize_stream(ours)
    assert shp == shape and crc2 == crc
    np.testing.assert_array_equal(w2, words)
    np.testing.assert_array_equal(st2, states)
    if tail:
        np.testing.assert_array_equal(k2, k)
    else:
        assert k2 is None
    assert tcodec.stream_impl_id(ours) == 5 and tcodec.stream_prec(ours) == 0


def test_symbol_checksum_matches_jax():
    syms = np.random.RandomState(5).randint(0, 6, (3, 4, 6, 7)).astype(np.int8)
    w = torch.from_numpy(tcodec.crc_weights(168).astype(np.int64))
    dev = tcodec.symbol_crc_device(torch.from_numpy(syms.reshape(3, -1)), w)
    for i in range(3):
        assert tcodec.symbol_crc(syms[i]) == jcodec.symbol_crc(syms[i]) == int(dev[i])


@pytest.mark.parametrize('shape', SHAPES)
def test_slice_roundtrip_matches_jax_theory(shape):
    """The whole K=3 slice on the CPU (plain versions): the port's streams
    round-trip bit-exactly through the port with the CRC verified, carry the
    reference's checksum, and their theoretical bits track the JAX pallas
    codec's within 1e-4 relative."""
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=6)
    syms = np.random.RandomState(6).randint(0, 6, (2,) + shape).astype(np.int8)
    jres = jcodec.LatentCodec(jm, cfg, impl='pallas').encode_batch(params, syms, centers)
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    res = lc.encode_batch(torch.from_numpy(syms.astype(np.int64)), torch.from_numpy(centers))
    dec = lc.decode_batch([r.bitstream for r in res], torch.from_numpy(centers))
    np.testing.assert_array_equal(dec.numpy(), syms.astype(np.int32))
    for r, jr in zip(res, jres):
        assert tcodec.stream_impl_id(r.bitstream) == tcodec.IMPL_CUDA
        assert tcodec.deserialize_stream(r.bitstream)[3] == \
            jcodec.deserialize_stream(jr.bitstream)[3]
        assert abs(r.theoretical_bits - jr.theoretical_bits) <= 1e-4 * jr.theoretical_bits


def test_decode_rejects_corrupt_stream():
    shape = (4, 6, 7)
    _, _, _, tm, tcfg, centers = _setup(shape, seed=7)
    syms = torch.from_numpy(np.random.RandomState(7).randint(0, 6, (1,) + shape))
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    bs = bytearray(lc.encode_batch(syms, torch.from_numpy(centers))[0].bitstream)
    bs[-3] ^= 0x5A
    with pytest.raises(ValueError, match='CRC'):
        lc.decode_batch([bytes(bs)], torch.from_numpy(centers))


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    _, _, _, tm, tcfg, _ = _setup((4, 6, 7))
    with pytest.raises(RuntimeError, match='cuda'):
        tcodec.LatentCodec(tm, tcfg)


def test_rans_primitives_match_jax():
    """quantize_cdf and one interleaved decode sub-iteration agree with the
    JAX rans module."""
    rng = np.random.RandomState(8)
    probs = rng.dirichlet(np.ones(6), size=(40,)).astype(np.float32)
    probs[0] = probs[0, [0, 0, 2, 3, 4, 5]]                # a tied argmax
    jf, jc = jrans.quantize_cdf(jnp.asarray(probs))
    tf, tc = trans.quantize_cdf(torch.from_numpy(probs))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # One 32-lane decode sub-iteration on random states and words.
    L32 = 32
    pr = rng.dirichlet(np.ones(6), size=(L32,)).astype(np.float32)
    fq, cl = trans.quantize_cdf(torch.from_numpy(pr))
    st = rng.randint(1 << 16, 1 << 32, L32, dtype=np.uint64).astype(np.uint32)
    stream = rng.randint(0, 1 << 16, 64).astype(np.uint32)
    a = rng.rand(L32) < 0.7
    js_, jst, jg, _ = jrans.decode_step_interleaved(
        jnp.asarray(st), jnp.int32(5), jnp.asarray(stream),
        jnp.asarray(fq.numpy().astype(np.uint32)), jnp.asarray(cl.numpy().astype(np.uint32)),
        jnp.asarray(a))
    ts_, tst, tg, _ = trans.decode_step_interleaved(
        torch.from_numpy(st.astype(np.int64))[None], torch.tensor([5]),
        torch.from_numpy(stream.astype(np.int64))[None], fq[None], cl[None],
        torch.from_numpy(a)[None], torch.zeros(1, L32, dtype=torch.long),
        torch.full((1, L32), 1 << 30, dtype=torch.long))
    np.testing.assert_array_equal(ts_[0].numpy(), np.asarray(js_))
    np.testing.assert_array_equal(tst[0].numpy().astype(np.uint32), np.asarray(jst))
    assert int(tg[0]) == int(jg)


def interleaved_encode(fs: torch.Tensor, ss: torch.Tensor, active: np.ndarray, x0: int):
    """The interleaved reverse encode of a batch over (T, M) tables, one
    rans.encode_reverse_step_interleaved sub-iteration at a time in JAX's
    encode_reverse_scan_interleaved order (steps and sub-iterations last
    first). fs / ss (B, T, M) int64 selected (freq, start), active (T, M)
    bool, with JAX's lanes: r = R_LANES, or M when M < R_LANES. Returns
    (words (B, T * M) int64 in emission order, n_words (B,), states (B, r),
    warmup counts k (B, r)); image b's decode-order stream is
    words[b, :n_words[b]] reversed."""
    B, T, m = fs.shape
    r = jrans.R_LANES if m >= jrans.R_LANES else m
    act = torch.from_numpy(np.asarray(active, bool))
    states = torch.full((B, r), x0, dtype=torch.long)
    gw = torch.zeros(B, dtype=torch.long)
    kwarm = torch.zeros(B, r, dtype=torch.long)
    words = torch.zeros(B, T * m, dtype=torch.long)
    for t in range(T - 1, -1, -1):
        for si in range(m // r - 1, -1, -1):
            sl = slice(si * r, (si + 1) * r)
            states, gw, kwarm = trans.encode_reverse_step_interleaved(
                states, gw, kwarm, fs[:, t, sl], ss[:, t, sl], act[t, sl].expand(B, r),
                words, count_warmup=True)
    return words, gw, states, kwarm


def interleaved_decode(encoded, freq: torch.Tensor, cdf: torch.Tensor, active: np.ndarray):
    """Decode interleaved_encode's output, one rans.decode_step_interleaved
    sub-iteration at a time: freq / cdf (B, T, M, L) int64 full tables.
    A lane stops pulling words after total - k symbols (tail packing).
    Returns (symbols (B, T, M) int64, [(states, gptr, cnt) after each step])."""
    words, n_words, states, k = encoded
    B, T, m, _ = freq.shape
    r = states.shape[1]
    act = torch.from_numpy(np.asarray(active, bool))
    stream = torch.zeros_like(words)
    for b in range(B):
        stream[b, :int(n_words[b])] = words[b, :int(n_words[b])].flip(0)
    thresh = act.reshape(T, m // r, r).sum((0, 1)).long()[None] - k
    gptr = torch.zeros(B, dtype=torch.long)
    cnt = torch.zeros(B, r, dtype=torch.long)
    syms = torch.zeros(B, T, m, dtype=torch.long)
    after = []
    for t in range(T):
        for si in range(m // r):
            sl = slice(si * r, (si + 1) * r)
            syms[:, t, sl], states, gptr, cnt = trans.decode_step_interleaved(
                states, gptr, stream, freq[:, t, sl], cdf[:, t, sl],
                act[t, sl].expand(B, r), cnt, thresh)
        after.append((states, gptr, cnt))
    return syms, after


def test_plain_k3_tables_unchanged():
    """The K=3 plain encode tables are pinned to their digest from before the
    CDF function moved into csrc/cdf.cuh (shared by kernels 2 and 5): the
    repair must not move a single entry."""
    import hashlib
    cfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    pc = tpc.ProbClassifier(cfg.replace(arch_param__k=8), 6, device='cpu')
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for p in pc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    syms = torch.from_numpy(np.random.RandomState(11).randint(0, 6, (2, 168))).int()
    fw = tcc.fold_weights(pc, torch.linspace(-2, 2, 6))
    f, s = ck.wavefront_forward_plain(ck.MODE_ENCODE, fw, (4, 6, 7), true_syms=syms)
    digest = hashlib.sha256(f.numpy().tobytes() + s.numpy().tobytes()).hexdigest()
    assert digest == 'f7ef5e73660c5d737b49131e64a9eb360814a5a7ddb311f7927b2fc8275ef2a5'


# ---------------------------------------------------------------------------
# Kernel 2's layer-parallel encode (plain layer-at-a-time version on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize('shape', SHAPES)
def test_layer_encode_equals_step_ordered_encode(shape):
    """All cells of a layer at once give exactly the tables of the
    step-ordered plain version (every output keeps its chain of roundings),
    dead lanes included, and the logits are the same floats."""
    _, _, _, tm, _, centers = _setup(shape, seed=9)
    syms = torch.from_numpy(np.random.RandomState(9).randint(0, 6, (2, int(np.prod(shape)))))
    fw = tcc.fold_weights(tm, torch.from_numpy(centers))
    (f_l, s_l), lg_l = ck.wavefront_encode_plain(fw, shape, syms.int(), return_logits=True)
    (f_s, s_s), lg_s = ck.wavefront_forward_plain(ck.MODE_ENCODE, fw, shape,
                                                  true_syms=syms.int(), return_logits=True)
    assert torch.equal(f_l, f_s) and torch.equal(s_l, s_s)
    assert torch.equal(lg_l, lg_s)
    # The wrapper's CPU path: layer-parallel by default, the scan on request.
    f_w, s_w = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms.int())
    f_o, s_o = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=syms.int(), scan=True)
    assert torch.equal(f_w, f_l) and torch.equal(s_w, s_l)
    assert torch.equal(f_o, f_l) and torch.equal(s_o, s_l)


def test_layer_encode_chunks_do_not_move_the_tables(monkeypatch):
    """The chunking of a layer's cells is invisible: 7 cells a chunk gives
    the tables of one chunk."""
    shape = (4, 6, 7)
    _, _, _, tm, _, centers = _setup(shape, seed=10)
    syms = torch.from_numpy(np.random.RandomState(10).randint(0, 6, (2, 168))).int()
    fw = tcc.fold_weights(tm, torch.from_numpy(centers))
    whole = ck.wavefront_encode_plain(fw, shape, syms)
    monkeypatch.setattr(ck, '_PLAIN_CHUNK_FLOATS', 2 * 14 * 8 * 7)
    parts = ck.wavefront_encode_plain(fw, shape, syms)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


@pytest.mark.parametrize('shape', SHAPES)
def test_layer_encode_tables_match_pallas(shape):
    """The layer-at-a-time tables against JAX make_forward(enc_parallel=True)
    in interpret mode, under the bound of the step-ordered version (ROADMAP
    Queue 3: |delta| <= 2 on a flip, at most 2 flips at (4, 6, 7), at most
    0.1% elsewhere)."""
    jm, cfg, params, tm, tcfg, centers = _setup(shape, seed=2)
    syms = np.random.RandomState(2).randint(0, 6, (2,) + shape)
    weights, _, jf, js, _, _ = _jax_tables(jm, cfg, params, centers, syms)
    tf, ts = ck.wavefront_encode_plain(_folded_from_jax(weights, 8), shape,
                                       torch.from_numpy(syms.reshape(2, -1)))
    act = ck.build_schedule(shape).idx_cm < np.prod(shape)
    flips = ((tf.numpy() != jf) | (ts.numpy() != js)) & act[None]
    assert np.abs(tf.numpy() - jf)[flips].max(initial=0) <= 2
    assert np.abs(ts.numpy() - js)[flips].max(initial=0) <= 2
    limit = 2 if shape == (4, 6, 7) else int(1e-3 * act.sum() * 2)
    assert flips.sum() <= limit, (flips.sum(), act.sum() * 2)
    assert not tf.numpy()[:, ~act].any() and not ts.numpy()[:, ~act].any()


def test_layer_encode_tables_match_pallas_kf64():
    """kf = 64, the width of pc cvpr/res_shallow_64 (the configs of both
    packages, a weight init of JAX's): the layer-at-a-time tables against
    JAX make_forward(enc_parallel=True) in interpret mode under the bound
    of the kf = 8 tests: |delta| <= 2 on a flip, and at most the 2 flips
    accepted at (4, 6, 7). A sum of 14 x 64 products rounds in another order
    in the Pallas kernel's dots: 1 flip of 150 entries here (ROADMAP Queue
    3)."""
    shape = (3, 5, 5)
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow_64', 'pc')
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow_64', 'pc')
    assert cfg.arch_param__k == tcfg.arch_param__k == 64
    jm = jpc.ProbClassifier(cfg, 6)
    params = jm.init(jax.random.PRNGKey(3), (1, shape[1], shape[2], shape[0]))
    tm = tpc.ProbClassifier(tcfg, 6, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    centers = np.linspace(-2.0, 2.0, 6).astype(np.float32)
    syms = np.random.RandomState(3).randint(0, 6, (2,) + shape)
    weights, _, jf, js, _, _ = _jax_tables(jm, cfg, params, centers, syms)
    mine = tcc.fold_weights(tm, torch.from_numpy(centers))
    for a, b in zip(mine, _folded_from_jax(weights, 64)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    tf, ts = ck.wavefront_encode_plain(mine, shape, torch.from_numpy(syms.reshape(2, -1)))
    act = ck.build_schedule(shape).idx_cm < np.prod(shape)
    flips = ((tf.numpy() != jf) | (ts.numpy() != js)) & act[None]
    assert np.abs(tf.numpy() - jf)[flips].max(initial=0) <= 2
    assert np.abs(ts.numpy() - js)[flips].max(initial=0) <= 2
    assert flips.sum() <= 2, (flips.sum(), act.sum() * 2)
    assert not tf.numpy()[:, ~act].any() and not ts.numpy()[:, ~act].any()


@pytest.mark.parametrize('shape', SHAPES)
def test_layer_encode_streams_equal_step_ordered_streams(shape, monkeypatch):
    """Streams written from the layer-parallel tables (the codec's path)
    are byte-identical to streams written from the step-ordered encode, and
    round-trip through the plain decode."""
    _, _, _, tm, tcfg, centers = _setup(shape, seed=12)
    syms = torch.from_numpy(np.random.RandomState(12).randint(0, 6, (2,) + shape))
    c = torch.from_numpy(centers)
    coder = tcc.CudaCoder(tm, tcfg, device='cpu')
    calls = []
    real = ck.wavefront_forward

    def spy(mode, *a, **k):
        calls.append((mode, k.get('scan', False)))
        return real(mode, *a, **k)

    monkeypatch.setattr(ck, 'wavefront_forward', spy)
    layered = [r.bitstream for r in coder.encode_batch(syms, c)]
    assert calls == [(ck.MODE_ENCODE, False)]
    monkeypatch.setattr(ck, 'wavefront_forward',
                        lambda mode, *a, **k: real(mode, *a, **dict(k, scan=True)))
    stepped = [r.bitstream for r in coder.encode_batch(syms, c)]
    assert layered == stepped
    monkeypatch.setattr(ck, 'wavefront_forward', real)
    assert torch.equal(coder.decode_batch(layered, c).long(), syms)


def test_schedule_slot_table():
    """slot4 names, for every layer-4 cell in step order, the column of its
    step's idx_cm row (where the scan puts the cell's logits)."""
    for shape in SHAPES + [(32, 8, 12)]:
        sched = ck.build_schedule(shape)
        cells = sched.layers[3]
        step = np.repeat(np.arange(sched.T), np.diff(cells.ptr))
        np.testing.assert_array_equal(sched.idx_cm[step, sched.slot4], cells.cells)
        assert sched.slot4.max() < sched.S * ck.R
