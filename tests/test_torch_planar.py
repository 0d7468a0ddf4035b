"""Port vs JAX package: the planar (K != 3) codec on the CPU.

The JAX planar codec runs its Pallas kernels in interpret mode, as its own
tests do; the port runs the plain PyTorch versions of kernels 5 and 6 (CPU
tensors). JAX results are built once per module (interpret mode costs tens
of seconds per encode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu.coding import planar as jplanar
from imgcomp_cvpr_tpu.coding import planar_kernel as jplk
from imgcomp_cvpr_tpu.coding import rans as jrans
from imgcomp_cvpr_tpu.coding.planar_codec import PlanarCoder as JPlanarCoder
from imgcomp_cvpr_tpu.models import probclass as jpc
from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch import weights as tweights
from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_codec as tcc
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as tck
from imgcomp_cvpr_tpu_torch.coding import planar as tplanar
from imgcomp_cvpr_tpu_torch.coding import planar_codec as tpcodec
from imgcomp_cvpr_tpu_torch.coding import planar_kernel as tplk
from imgcomp_cvpr_tpu_torch.models import probclass as tpc
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

SHAPE = (4, 8, 8)
L = 6
B = 2
R = tplanar.R
CENTERS = np.linspace(-2.0, 2.0, L).astype(np.float32)


def _models(K, kf=8, seed=1):
    """The same random context model in both packages: the JAX init carried
    across with weights.pc_state_dict."""
    cfg, _ = jconfig.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(kernel_size=K, arch_param__k=kf)
    jm = jpc.ProbClassifier(cfg, L)
    params = jm.init(jax.random.PRNGKey(seed), (1, SHAPE[1], SHAPE[2], SHAPE[0]))
    tcfg, _ = tconfig.parse_spec('cvpr/res_shallow', 'pc')
    tcfg = tcfg.replace(kernel_size=K, arch_param__k=kf)
    tm = tpc.ProbClassifier(tcfg, L, device='cpu')
    tm.load_state_dict(tweights.pc_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jm, cfg, params, tm, tcfg


@pytest.fixture(scope='module')
def jax_k5():
    """JAX planar encode of B=2 symbol volumes at K=5 through its split
    encode path (make_plane_forward(enc_teacher=True, interpret=True), bsub=1),
    with the reverse kernel swapped for one that hands the (freq, start)
    tables out; plus the real make_plane_reverse on those tables for both
    lane seeds."""
    jm, cfg, params, tm, tcfg = _models(5)
    syms = np.random.RandomState(0).randint(0, L, (B,) + SHAPE).astype(np.int8)
    sched = jplanar.build_planar_schedule(SHAPE, 5)
    orig = jplk.make_plane_reverse

    def tables_out(latent_shape, K, b, bsub=1, L=0, interpret=False, x0=jrans.RANS_L):
        zeros = jnp.zeros((b, 1, bsub * R), jnp.uint32)
        return (lambda table, acm, f, s: (f, s, zeros, zeros.astype(jnp.int32))), sched

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('IMGCOMP_PLANAR_BSUB', '1')
        mp.setattr(jplk, 'make_plane_reverse', tables_out)
        ks = JPlanarCoder(jm, cfg)._run_fns(SHAPE, B)
        outs = ks.encode_full(params, jnp.asarray(CENTERS),
                              jnp.asarray(syms.reshape(B, -1)), rneed=0, x0=1)
    fsel_full, ssel_full, theo = outs[0], outs[1], np.asarray(outs[4])
    C, T2, T2p = SHAPE[0], sched.T2, sched.T2_pad

    def trim(x):   # (B, C*T2_pad, 1, 128) -> (B, C*T2, R)
        return np.asarray(x).reshape(B, C, T2p, -1)[:, :, :T2, :R].reshape(B, C * T2, R)

    acm = np.zeros((T2p, 1, 128), np.int32)
    acm[:, :, :R] = sched.active_cm
    full_table = jnp.asarray(np.tile(sched.table[:, :, :2], (C, 1, 1)))
    full_acm = jnp.asarray(np.tile(acm, (C, 1, 1)))
    rev = {}
    for x0 in (1, jrans.RANS_L):
        fn, _ = orig(SHAPE, 5, B, bsub=1, L=L, interpret=True, x0=x0)
        rev[x0] = [np.asarray(a) for a in fn(full_table, full_acm, fsel_full, ssel_full)]
    return dict(tm=tm, tcfg=tcfg, syms=syms, fsel=trim(fsel_full), ssel=trim(ssel_full),
                theo=theo, rev=rev)


@pytest.mark.parametrize('K', [3, 5])
@pytest.mark.parametrize('shape', [(4, 8, 8), (3, 5, 9), (2, 12, 6), (32, 64, 96)])
def test_schedule_matches_jax(shape, K):
    ours = tplanar.build_planar_schedule(shape, K)
    ref = jplanar.build_planar_schedule(shape, K)
    assert tplanar.geometry(K) == jplanar.geometry(K)
    assert tplanar.grids_2d(shape[1:], K) == jplanar.grids_2d(shape[1:], K)
    assert (ours.BH, ours.CTR, ours.T2, ours.grids, ours.taps, ours.n_band, ours.wcap) == \
        (ref.BH, ref.CTR, ref.T2, ref.grids, ref.taps, ref.n_band, ref.wcap)
    T2 = ours.T2
    np.testing.assert_array_equal(ours.h_lo, ref.h_lo[:T2])
    np.testing.assert_array_equal(ours.idx_cm, ref.idx_cm[:T2])
    np.testing.assert_array_equal(ours.table, ref.table[:T2])
    np.testing.assert_array_equal(ours.active_cm, ref.active_cm[:T2])
    # JAX pads the steps to its TPU step blocks; the padded steps are empty.
    assert not ref.active_cm[T2:].any()
    assert ours.stream_cap == jplk.plane_stream_rows(ref, 1) * 128


@pytest.mark.parametrize('K,shape', [(5, (4, 8, 8)), (5, (3, 5, 9)), (3, (2, 12, 6))])
def test_plain_plane_logits_match_full_network(K, shape):
    """Plane by plane through kernel 5's plain version (bias rows, per-step
    cells, pad constants, the level-1 skip) reproduces
    ProbClassifier.logits on the whole padded volume."""
    _, _, _, tm, tcfg = _models(K)
    syms = torch.from_numpy(np.random.RandomState(2).randint(0, L, (2,) + shape)).int()
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    sched, fold = coder._prepare(shape, torch.from_numpy(CENTERS))
    hist = coder._history(fold, sched, 2)
    lg = []
    for d in range(shape[0]):
        out, lgd = tplk.plane_forward_plain(tplk.MODE_ENCODE, fold.top, shape, K,
                                            coder.bias_rows(fold, hist),
                                            true_plane=syms[:, d], return_logits=True)
        lg.append(lgd)
        coder._push(hist, out)
    q = torch.from_numpy(CENTERS)[syms.long()].permute(0, 2, 3, 1)
    ref = tm.logits(q, float(CENTERS[0])).detach()
    # Summation order differs (sequential taps vs conv3d): ~1e-6 relative.
    np.testing.assert_allclose(torch.stack(lg, 1).reshape(ref.shape).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_pc_state_dict_carries_k5_weights():
    """weights.pc_state_dict maps K=5 (kd=3) JAX kernels: the port's logits
    equal the JAX model's."""
    jm, cfg, params, tm, _ = _models(5)
    q = np.random.RandomState(3).choice(CENTERS, (2,) + SHAPE[1:] + SHAPE[:1]).astype(np.float32)
    ref = np.asarray(jm.logits(params, jnp.asarray(q), float(CENTERS[0])))
    ours = tm.logits(torch.from_numpy(q), float(CENTERS[0])).detach().numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_plain_encode_tables_match_jax(jax_k5):
    """Kernel 5's plain version (through PlanarCoder) against JAX
    make_plane_forward(enc_teacher=True): the logits are summed in another
    order (XLA's dots and convolutions vs sequential taps) and XLA's and
    torch's CPU exp differ by an ulp on a share of inputs; the 2^16 CDF scale
    turns such ulps into rare +-1 flips of (freq, start). Every mismatch must be such a boundary flip
    (|delta| <= 2); the 2 flips of 512 active entries measured here are an
    accepted library difference (ROADMAP Queue 3) and the bound."""
    d = jax_k5
    coder = tpcodec.PlanarCoder(d['tm'], d['tcfg'], device='cpu')
    _, fold = coder._prepare(SHAPE, torch.from_numpy(CENTERS))
    tf, ts = coder.encode_tables(torch.from_numpy(d['syms']).int(), fold)
    act = tplk._full_active(tplanar.build_planar_schedule(SHAPE, 5))[None]
    flips = ((tf.numpy() != d['fsel']) | (ts.numpy() != d['ssel'])) & act
    assert np.abs(tf.numpy() - d['fsel'])[flips].max(initial=0) <= 2
    assert np.abs(ts.numpy() - d['ssel'])[flips].max(initial=0) <= 2
    assert flips.sum() <= 2, (flips.sum(), act.sum() * B)


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
def test_plain_reverse_byte_identical_to_jax(jax_k5, x0):
    """Kernel 6's plain version fed JAX's tables writes JAX
    make_plane_reverse's words, word counts, final states and warmups."""
    d = jax_k5
    jw, jn, jst, jk = d['rev'][x0]
    tw, tn, tst, tk = tplk.plane_reverse_plain(torch.from_numpy(d['fsel']),
                                               torch.from_numpy(d['ssel']), SHAPE, 5, x0)
    np.testing.assert_array_equal(tn.numpy(), jn.reshape(B))
    for i in range(B):
        np.testing.assert_array_equal(tw[i, :tn[i]].numpy().astype(np.uint32),
                                      jw[i].reshape(-1)[:jn[i, 0, 0]])
    np.testing.assert_array_equal(tst.numpy().view(np.uint32), jst.reshape(B, R))
    np.testing.assert_array_equal(tk.numpy(), jk.reshape(B, R))
    if x0 == 1:
        assert tk.numpy().max() > 0


@pytest.mark.parametrize('x0', [1, jrans.RANS_L])
def test_plain_list_walker_byte_identical_to_jax(jax_k5, x0):
    """The plain walker over the host-built list of non-empty (plane, step)
    rows (what kernel 6 runs) writes JAX make_plane_reverse's words, word
    counts, final states and warmups."""
    d = jax_k5
    jw, jn, jst, jk = d['rev'][x0]
    sched = tplanar.build_planar_schedule(SHAPE, 5)
    rows, masks = tck.reverse_list(tplk._full_active(sched))
    tw, tn, tst, tk = tck.reverse_plain_list(torch.from_numpy(d['fsel']),
                                             torch.from_numpy(d['ssel']), rows, masks,
                                             sched.stream_cap, x0)
    np.testing.assert_array_equal(tn.numpy(), jn.reshape(B))
    for i in range(B):
        np.testing.assert_array_equal(tw[i, :tn[i]].numpy().astype(np.uint32),
                                      jw[i].reshape(-1)[:jn[i, 0, 0]])
    np.testing.assert_array_equal(tst.numpy().view(np.uint32), jst.reshape(B, R))
    np.testing.assert_array_equal(tk.numpy(), jk.reshape(B, R))


# (4, 8, 8): every one of the 4 x 64 rows is non-empty; the Kodak latent
# (32, 64, 96): 32 planes x T2 = 823 rows, of which 21,216 are non-empty (9.3
# active lanes each on average).
@pytest.mark.parametrize('shape,count', [((4, 8, 8), 256), ((32, 64, 96), 21216)])
def test_plane_reverse_list_is_the_active_rows(shape, count):
    """The list kernel 6 walks is {(plane, step): active row} in reverse
    coding order (plane C-1 .. 0, step T2-1 .. 0), each with the exact lane
    mask."""
    sched = tplanar.build_planar_schedule(shape, 5)
    step_act = sched.idx_cm < shape[1] * shape[2]                   # (T2, R)
    rows, masks = tck.reverse_list(tplk._full_active(sched))
    want = [(d, t) for d in range(shape[0] - 1, -1, -1) for t in range(sched.T2 - 1, -1, -1)
            if step_act[t].any()]
    assert len(rows) == len(want) == count
    assert list(zip((rows // sched.T2).tolist(), (rows % sched.T2).tolist())) == want
    bits = np.unpackbits(masks.view(np.uint8), bitorder='little').reshape(-1, R)
    np.testing.assert_array_equal(bits.astype(bool), step_act[rows % sched.T2])


def test_k5_roundtrip_and_theory(jax_k5):
    """The port's K=5 codec on the CPU: bit-exact round trip (impl id 6,
    CRC verified); its theoretical bits within 5e-3 of the port's
    ProbClassifier.bitcost sum and within 1e-3 of JAX's planar codec."""
    d = jax_k5
    syms = torch.from_numpy(d['syms'].astype(np.int64))
    centers = torch.from_numpy(CENTERS)
    lc = tcodec.LatentCodec(d['tm'], d['tcfg'], device='cpu')
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers)
    assert torch.equal(dec.long(), syms)
    q = centers[syms].permute(0, 2, 3, 1)
    bc = d['tm'].bitcost(q, syms.permute(0, 2, 3, 1), float(CENTERS[0]))
    loss_bits = bc.sum((1, 2, 3)).detach().numpy()
    for r, lb, jt in zip(res, loss_bits, d['theo']):
        assert tcodec.stream_impl_id(r.bitstream) == tcodec.IMPL_CUDA_PLANAR
        assert abs(r.theoretical_bits - lb) / lb < 5e-3
        assert abs(r.theoretical_bits - jt) / jt < 1e-3
        assert r.num_bits >= r.theoretical_bits


def test_tail_packing_per_plane_thresholds():
    """(8, 8, 8) at K=5 puts every symbol of a plane in lane 0, so that lane
    reaches TAIL_MIN_LANE_SYMBOLS: the streams are tail-packed (x0 = 1, the
    k-table on the wire) and decode only through the per-plane thresholds."""
    shape = (8, 8, 8)
    _, _, _, tm, tcfg = _models(5)
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    assert coder.lane_totals(shape).max() >= tcodec.TAIL_MIN_LANE_SYMBOLS
    syms = torch.from_numpy(np.random.RandomState(5).randint(0, L, (2,) + shape))
    centers = torch.from_numpy(CENTERS)
    res = coder.encode_batch(syms, centers)
    for r in res:
        k = tcodec.deserialize_stream(r.bitstream)[4]
        assert k is not None and k.max() > 0
    assert torch.equal(coder.decode_batch([r.bitstream for r in res], centers).long(), syms)


def test_streams_batch_invariant():
    """Streams do not depend on the batch: B=2 and B=1 encodes are
    byte-identical, and each stream of a B=3 encode decodes alone."""
    _, _, _, tm, tcfg = _models(5, seed=6)
    syms = torch.from_numpy(np.random.RandomState(6).randint(0, L, (3,) + SHAPE))
    centers = torch.from_numpy(CENTERS)
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    res3 = lc.encode_batch(syms, centers)
    res2 = lc.encode_batch(syms[:2], centers)
    for i in range(3):
        one = lc.encode_batch(syms[i:i + 1], centers)[0].bitstream
        assert one == res3[i].bitstream
        if i < 2:
            assert one == res2[i].bitstream
        assert torch.equal(lc.decode_batch([res3[i].bitstream], centers)[0].long(), syms[i])


def test_k3_planar_theory_matches_wavefront():
    """The planar coder also takes K=3: its theoretical bits are within 1e-3
    of the K=3 wavefront codec's (CudaCoder); LatentCodec decodes either
    codec's streams by their impl id."""
    _, _, _, tm, tcfg = _models(3, seed=7)
    syms = torch.from_numpy(np.random.RandomState(7).randint(0, L, (2,) + SHAPE))
    centers = torch.from_numpy(CENTERS)
    planar_res = tpcodec.PlanarCoder(tm, tcfg, device='cpu').encode_batch(syms, centers)
    wave_res = tcc.CudaCoder(tm, tcfg, device='cpu').encode_batch(syms, centers)
    for a, b in zip(planar_res, wave_res):
        assert abs(a.theoretical_bits - b.theoretical_bits) / b.theoretical_bits < 1e-3
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    for res in (planar_res, wave_res):
        assert torch.equal(lc.decode_batch([r.bitstream for r in res], centers).long(), syms)
    with pytest.raises(ValueError, match='mixed impl ids'):
        lc.decode_batch([planar_res[0].bitstream, wave_res[0].bitstream], centers)


def test_impl_id_routing():
    """Impl 6 routes to PlanarCoder and impl 5 to CudaCoder; the port
    rejects the JAX package's impl ids 0-4."""
    _, _, _, tm, tcfg = _models(5)
    lc = tcodec.LatentCodec(tm, tcfg, device='cpu')
    assert lc.impl_id == tcodec.IMPL_CUDA_PLANAR == 6
    assert isinstance(lc.coder(6), tpcodec.PlanarCoder)
    assert isinstance(tcodec.LatentCodec(*_models(3)[3:], device='cpu').coder(5),
                      tcc.CudaCoder)
    stream = tcodec.serialize_stream(SHAPE, np.zeros(4, np.uint32),
                                     np.full(R, 1 << 16, np.uint32), impl_id=3)
    for impl in range(5):
        with pytest.raises(ValueError, match='not decodable'):
            lc.coder(impl)
    with pytest.raises(ValueError, match='not decodable'):
        lc.decode_batch([stream], torch.from_numpy(CENTERS))


def test_seeded_init_matches_jax_initializer():
    """probclass.init_params: glorot-uniform weights (the JAX initializer's
    bound, fan over kd*K*K), zero biases, reproducible from the seed."""
    cfg, _ = tconfig.parse_spec('base', 'pc')
    a = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), seed=3)
    b = tpc.init_params(tpc.ProbClassifier(cfg, L, device='cpu'), seed=3)
    jm = jpc.ProbClassifier(jconfig.parse_spec('base', 'pc')[0], L)
    jp = jm.init(jax.random.PRNGKey(0), (1, 8, 8, 4))['params']
    for name in ('conv0', 'res1.conv1', 'res1.conv2', 'conv_out'):
        conv = a.net.get_submodule(name)
        node = jp
        for part in name.split('.'):
            node = node[part]
        jw = np.asarray(node['w'])
        assert tuple(conv.weight.shape) == jw.transpose(4, 3, 0, 1, 2).shape
        limit = np.sqrt(6.0 / (np.prod(jw.shape[:3]) * (jw.shape[3] + jw.shape[4])))
        w = conv.weight.detach().numpy()
        assert np.abs(w).max() <= limit and np.abs(jw).max() <= limit
        assert np.abs(w).max() > 0.9 * limit
        assert abs(w.std() - jw.std()) < 0.1 * jw.std()
        assert not conv.bias.detach().any()
        assert torch.equal(conv.weight, b.net.get_submodule(name).weight)


# ---------------------------------------------------------------------------
# Kernel 5's layer-parallel encode (plain layer-at-a-time version on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Six test workers run side by side: one intra-op thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.mark.parametrize('K,shape', [(5, (4, 8, 8)), (5, (3, 5, 9)), (3, (2, 12, 6))])
def test_level_encode_equals_plane_scan(K, shape):
    """Level by level over all planes gives exactly the tables of the
    plane-by-plane step-ordered plain version, dead lanes included."""
    _, _, _, tm, tcfg = _models(K, seed=3)
    with torch.no_grad():                                  # biases are 0 at init
        for name, p in tm.named_parameters():
            if name.endswith('bias'):
                p.copy_(torch.from_numpy(
                    np.random.RandomState(4).randn(*p.shape).astype(np.float32) * 0.1))
    syms = torch.from_numpy(np.random.RandomState(3).randint(0, L, (B,) + shape)).int()
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    _, fold = coder._prepare(shape, torch.from_numpy(CENTERS))
    f_l, s_l = coder.encode_tables(syms, fold)
    f_s, s_s = coder.encode_tables_scan(syms, fold)
    assert torch.equal(f_l, f_s) and torch.equal(s_l, s_s)
    f_p, s_p = coder.encode_tables(syms, fold, plain=True)
    assert torch.equal(f_p, f_l) and torch.equal(s_p, s_l)
    act = tplk._full_active(tplanar.build_planar_schedule(shape, K))
    assert f_l.numpy()[:, act].min() >= 1 and not f_l.numpy()[:, ~act].any()


def test_scan_encode_tables_match_jax(jax_k5):
    """The step-ordered plain encode (the scan's plain version, plane by
    plane) against JAX make_plane_forward(enc_teacher=True) under the same
    bound as the layer-parallel path (ROADMAP Queue 3: |delta| <= 2, at most
    2 flips of 512 active entries)."""
    d = jax_k5
    coder = tpcodec.PlanarCoder(d['tm'], d['tcfg'], device='cpu')
    _, fold = coder._prepare(SHAPE, torch.from_numpy(CENTERS))
    tf, ts = coder.encode_tables_scan(torch.from_numpy(d['syms']).int(), fold)
    act = tplk._full_active(tplanar.build_planar_schedule(SHAPE, 5))[None]
    flips = ((tf.numpy() != d['fsel']) | (ts.numpy() != d['ssel'])) & act
    assert np.abs(tf.numpy() - d['fsel'])[flips].max(initial=0) <= 2
    assert np.abs(ts.numpy() - d['ssel'])[flips].max(initial=0) <= 2
    assert flips.sum() <= 2, (flips.sum(), act.sum() * B)


@pytest.mark.parametrize('shape', [(4, 8, 8), (3, 5, 9)])
def test_level_encode_streams_equal_scan_streams(shape, monkeypatch):
    """Streams written from the layer-parallel tables (the codec's path) are
    byte-identical to streams written from the plane-by-plane scan's, and
    round-trip through the plain decode."""
    _, _, _, tm, tcfg = _models(5, seed=8)
    syms = torch.from_numpy(np.random.RandomState(8).randint(0, L, (B,) + shape))
    centers = torch.from_numpy(CENTERS)
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    layered = [r.bitstream for r in coder.encode_batch(syms, centers)]
    monkeypatch.setattr(coder, 'encode_tables', coder.encode_tables_scan)
    stepped = [r.bitstream for r in coder.encode_batch(syms, centers)]
    assert layered == stepped
    assert torch.equal(coder.decode_batch(layered, centers).long(), syms)


@pytest.mark.parametrize('level', [1, 2, 3, 4])
def test_level_forward_is_the_network_layer(level):
    """One level of kernel 5's plain encode pass plus nothing else is the
    masked convolution's top slice: with zero bias rows, level_forward on a
    random level below equals a plain cross-correlation over the unmasked
    top-slice taps."""
    shape, K, kf = (2, 5, 9), 5, 8
    _, _, _, tm, tcfg = _models(K, kf=kf, seed=5)
    coder = tpcodec.PlanarCoder(tm, tcfg, device='cpu')
    sched, fold = coder._prepare(shape, torch.from_numpy(CENTERS))
    rng = np.random.RandomState(level)
    gs, gl = sched.grids[level - 1], sched.grids[level]
    cin, cout = (1 if level == 1 else kf), (L if level == 4 else kf)
    src = torch.from_numpy(rng.randn(3, *gs, cin).astype(np.float32))
    bias = torch.zeros(3, *gl, cout)
    skip = torch.from_numpy(rng.randn(3, *sched.grids[1], kf).astype(np.float32))
    out = tplk.level_forward(level, fold.top, shape, K, src[..., 0] if level == 1 else src,
                             bias, skip=skip if level == 3 else None)
    w = fold.top[level - 1]
    ref = torch.zeros(3, *gl, cout, dtype=torch.float64)
    for k, (dy, dx) in enumerate(sched.taps[level - 1]):
        ref += src[:, dy:dy + gl[0], dx:dx + gl[1]].double() @ w[k].double()
    if level == 3:
        ref = ref + skip[:, K - 1:K - 1 + gl[0], K - 1:K - 1 + gl[1]].double()
    else:
        ref = torch.relu(ref)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
