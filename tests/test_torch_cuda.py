"""Card-only tests of the port's CUDA kernels against their plain versions.

Marked ``cuda``; the ``cuda_device`` fixture skips them when no card is
present. This file imports no JAX (the machine with the card has none):
run it there with ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import ae_eager
from imgcomp_cvpr_tpu_torch.coding import codec, cuda_codec, cuda_kernel as ck, rans
from imgcomp_cvpr_tpu_torch.coding import planar, planar_codec, planar_kernel as plk
from imgcomp_cvpr_tpu_torch.models import probclass as pcl
from imgcomp_cvpr_tpu_torch.models import quantizer as quantizer_lib
from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
from imgcomp_cvpr_tpu_torch.ops.kernels import build, quantize as qk
from imgcomp_cvpr_tpu_torch.utils import config as config_lib

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _pc(device, kf=8, L=6, seed=0):
    cfg, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    cfg = cfg.replace(arch_param__k=kf)
    pc = pcl.ProbClassifier(cfg, L, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pc.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return pc, cfg


def test_quantize_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 17, 29, 32).astype(np.float32) * 2).to(cuda_device)
    c = torch.from_numpy(np.sort(rng.uniform(-2, 2, 6)).astype(np.float32)).to(cuda_device)
    before = build.LAUNCHES['quantize']
    qs, qh, sym = qk.quantize_fwd(x, c)
    assert build.LAUNCHES['quantize'] == before + 1
    ps, ph, psym = qk.quantize_plain(x, c)
    torch.cuda.synchronize()
    assert torch.equal(sym, psym)
    assert torch.equal(qh, ph)
    # expf vs torch.exp and FMA contraction: a few ulp of the [-2, 2] range.
    assert (qs - ps).abs().max().item() <= 1e-6


@pytest.mark.parametrize('shape', [(4, 6, 7), (9, 5, 6)])
def test_forward_encode_kernel_matches_plain(cuda_device, shape):
    pc, _ = _pc(cuda_device)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    w = cuda_codec.fold_weights(pc, centers)
    rng = np.random.RandomState(1)
    syms = torch.from_numpy(rng.randint(0, 6, (2, int(np.prod(shape))))).int().to(cuda_device)
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, scan=True)
    fp, sp = ck.wavefront_forward_plain(ck.MODE_ENCODE, w, shape, true_syms=syms)
    act = torch.from_numpy(ck.build_schedule(shape).idx_cm < np.prod(shape)).to(cuda_device)
    flips = ((fk != fp) | (sk != sp)) & act
    # The plain version repeats the kernel's roundings, so the tables should
    # agree exactly; up to 0.1% boundary flips are tolerated (expf vs
    # torch.exp may differ by an ulp).
    assert flips.sum().item() <= int(1e-3 * act.sum().item() * 2)


@pytest.mark.parametrize('x0', [1, rans.RANS_L])
def test_reverse_kernel_byte_identical(cuda_device, x0):
    shape = (9, 5, 6)
    pc, _ = _pc(cuda_device, seed=2)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    w = cuda_codec.fold_weights(pc, centers)
    rng = np.random.RandomState(2)
    syms = torch.from_numpy(rng.randint(0, 6, (3, int(np.prod(shape))))).int().to(cuda_device)
    fsel, ssel = ck.wavefront_forward_plain(ck.MODE_ENCODE, w, shape, true_syms=syms)
    wk, nk, stk, kk = ck.rans_reverse(fsel, ssel, shape, x0)
    wp, npl, stp, kp = ck.rans_reverse_plain(fsel, ssel, shape, x0)
    assert torch.equal(nk, npl)
    for i in range(3):
        assert torch.equal(wk[i, :nk[i]], wp[i, :npl[i]])
    assert torch.equal(stk, stp) and torch.equal(kk, kp)


def test_codec_roundtrip_through_kernels(cuda_device):
    shape = (9, 5, 6)
    pc, cfg = _pc(cuda_device, seed=3)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    rng = np.random.RandomState(3)
    syms = torch.from_numpy(rng.randint(0, 6, (2,) + shape)).to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    build.reset_launches()
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers)
    assert torch.equal(dec.long(), syms.long())
    assert build.LAUNCHES['wavefront_forward_encode'] == 1
    assert build.LAUNCHES['wavefront_forward_decode'] == 1
    assert build.LAUNCHES['rans_reverse'] == 1
    assert all(codec.stream_impl_id(r.bitstream) == codec.IMPL_CUDA for r in res)


# ---------------------------------------------------------------------------
# Planar codec (kernels 5 and 6)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Layer-parallel encode and cluster decode of kernel 2 (K=3)
# ---------------------------------------------------------------------------

def _k3_case(device, shape, kf, L, b, seed):
    pc, cfg = _pc(device, kf=kf, L=L, seed=seed)
    centers = torch.linspace(-2, 2, L, device=device)
    n = int(np.prod(shape))
    syms = torch.from_numpy(np.random.RandomState(seed).randint(0, L, (b, n))).int().to(device)
    return pc, cfg, centers, cuda_codec.fold_weights(pc, centers), syms


# kf = 24, L = 6 is the instance with compile-time widths; (24, 8) and
# (8, 6) go through the generic instance. (3, 5, 5) never has a warp's worth
# of cells in a step.
@pytest.mark.parametrize('kf,L', [(24, 6), (24, 8), (8, 6)])
@pytest.mark.parametrize('shape', [(3, 5, 5), (4, 6, 7), (6, 10, 12)])
def test_parallel_encode_equals_scan(cuda_device, shape, kf, L):
    """The layer-parallel encode tables equal the scan's mode-1 tables entry
    for entry (dead lanes too: both write 0), and the plain layer-at-a-time
    version's up to the expf-vs-torch.exp flip allowance."""
    _, _, _, w, syms = _k3_case(cuda_device, shape, kf, L, 2, seed=5)
    build.reset_launches()
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms)
    assert build.LAUNCHES['wavefront_forward_encode'] == 1
    fs, ss = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, scan=True)
    assert build.LAUNCHES['wavefront_forward_encode_scan'] == 1
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    fp, sp = ck.wavefront_encode_plain(w, shape, syms)
    flips = (fk != fp) | (sk != sp)
    assert flips.sum().item() <= int(1e-3 * syms.numel() * 2)
    fq, sq = ck.wavefront_forward_plain(ck.MODE_ENCODE, w, shape, true_syms=syms)
    assert torch.equal(fp, fq) and torch.equal(sp, sq)


@pytest.mark.parametrize('b', [1, 3, 17])
def test_cluster_decode_any_batch(cuda_device, b):
    """Decode of B = 1, 3 and 17 images, one image over a thread-block
    cluster, recovers the symbols; every cluster size decodes the same
    symbols, and the streams equal B = 1 streams (no sum is split)."""
    shape = (6, 10, 12)
    pc, cfg, centers, w, syms = _k3_case(cuda_device, shape, 24, 6, b, seed=6)
    coder = cuda_codec.CudaCoder(pc, cfg, device=cuda_device)
    res = coder.encode_batch(syms.reshape((b,) + shape), centers)
    dec = coder.decode_batch([r.bitstream for r in res], centers)
    assert torch.equal(dec.reshape(b, -1), syms)
    one = coder.encode_batch(syms[b - 1:].reshape((1,) + shape), centers)[0].bitstream
    assert one == res[b - 1].bitstream
    pb = cuda_codec.parse_batch([r.bitstream for r in res],
                                lambda s: ck.build_schedule(s).stream_cap,
                                lambda s: ck.lane_totals(ck.build_schedule(s)))
    args = dict(zip(('streams', 'init_states', 'thresh'), cuda_codec.upload_parsed(
        pb, ck.build_schedule(shape).stream_cap, cuda_device)))
    for cluster in (1, 2, 3, 6, 8):
        out = ck.wavefront_forward(ck.MODE_DECODE, w, shape, cluster=cluster, **args)
        assert torch.equal(out, syms), cluster
    sched = ck.build_schedule(shape)
    assert ck.max_active_clusters(24, 6, sched.CQ, sched.T, 8) >= 1
    assert 1 <= ck.scan_cluster(24, 6, sched.CQ, sched.T, b) <= ck.MAX_CLUSTER


def test_generic_instance_roundtrip(cuda_device):
    """kf = 16, L = 9 (no compile-time instance): kernel 2 encode vs plain,
    and a round trip through the generic scan."""
    shape = (5, 7, 9)
    pc, cfg, centers, w, syms = _k3_case(cuda_device, shape, 16, 9, 2, seed=7)
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms)
    fp, sp = ck.wavefront_encode_plain(w, shape, syms)
    assert ((fk != fp) | (sk != sp)).sum().item() <= int(1e-3 * syms.numel() * 2)
    coder = cuda_codec.CudaCoder(pc, cfg, device=cuda_device)
    res = coder.encode_batch(syms.reshape((2,) + shape), centers)
    assert torch.equal(coder.decode_batch([r.bitstream for r in res], centers).reshape(2, -1),
                       syms)


# ---------------------------------------------------------------------------
# Context models past shared memory (kf = 64, `pc cvpr/res_shallow_64`)
# ---------------------------------------------------------------------------

def _pc64(device, seed):
    cfg, _ = config_lib.parse_spec('cvpr/res_shallow_64', 'pc')
    assert cfg.arch_param__k == 64
    return pcl.init_params(pcl.ProbClassifier(cfg, 6, device=device), seed), cfg


@pytest.mark.parametrize('shape', [(4, 6, 7), (6, 10, 12)])
def test_k3_kf64_encode_equals_scan_plain_and_roundtrips(cuda_device, shape):
    """kf = 64 at L = 6: the weights (474 KB) stay in device memory for the
    scan and the encode; the layer-parallel tables equal the scan's on every
    entry and the plain version's up to the flip allowance; the generic
    instance gives the same tables as the compile-time one; a CRC-verified
    round trip through the codec recovers the symbols."""
    pc, cfg = _pc64(cuda_device, seed=12)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    w = cuda_codec.fold_weights(pc, centers)
    sched = ck.build_schedule(shape)
    assert ck.weights_in_device(64, 6, sched.CQ, sched.T)
    assert ck.weights_in_device(64, 6, sched.CQ, sched.T, encode=True)
    syms = torch.from_numpy(np.random.RandomState(12).randint(0, 6, (3, int(np.prod(shape)))))
    syms = syms.int().to(cuda_device)
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms)
    fs, ss = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, scan=True)
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    for force in (ck.FORCE_GENERIC, ck.FORCE_GENERIC | ck.FORCE_WDEV):
        fg, sg = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, force=force)
        assert torch.equal(fk, fg) and torch.equal(sk, sg), force
        fg, sg = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, scan=True,
                                      force=force)
        assert torch.equal(fk, fg) and torch.equal(sk, sg), force
    fp, sp = ck.wavefront_encode_plain(w, shape, syms)
    assert ((fk != fp) | (sk != sp)).sum().item() <= int(1e-3 * syms.numel())
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    build.reset_launches()
    res = lc.encode_batch(syms.reshape((3,) + shape), centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
    assert torch.equal(dec.reshape(3, -1), syms)
    assert build.LAUNCHES['wavefront_forward_encode'] == 1
    assert build.LAUNCHES['wavefront_forward_decode'] == 1


@pytest.mark.parametrize('kf', [24, 64])
def test_wdev_counter_counts_device_memory_launches(cuda_device, kf):
    """LAUNCHES['wavefront_wdev'] counts every kernel-2 call of a kf = 64
    round trip through the codec (its weights in device memory) and none of
    a kf = 24 one (its weights in shared memory)."""
    shape = (6, 10, 12)
    pc, cfg = _pc64(cuda_device, seed=14) if kf == 64 else _pc(cuda_device, kf=24, seed=14)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    syms = torch.from_numpy(np.random.RandomState(14).randint(0, 6, (2,) + shape))
    syms = syms.int().to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    build.reset_launches()
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
    assert torch.equal(dec.reshape(syms.shape), syms)
    k2 = sum(v for k, v in build.LAUNCHES.items() if k.startswith('wavefront_forward'))
    assert k2 == 2
    assert build.LAUNCHES['wavefront_wdev'] == (k2 if kf == 64 else 0)


@pytest.mark.parametrize('force', [1, 2, 3])
def test_k3_weight_placement_keeps_the_bits(cuda_device, force):
    """kf = 24 (weights in shared memory by default): the weights read from
    device memory (force 1), the generic instance (2) and both (3) give the
    same encode tables, scan tables and decoded symbols as the default."""
    shape = (6, 10, 12)
    pc, cfg, centers, w, syms = _k3_case(cuda_device, shape, 24, 6, 2, seed=13)
    sched = ck.build_schedule(shape)
    assert not ck.weights_in_device(24, 6, sched.CQ, sched.T)
    assert ck.weights_in_device(24, 6, sched.CQ, sched.T, force=ck.FORCE_WDEV)
    ref = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms)
    for scan in (False, True):
        out = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, scan=scan,
                                   force=force)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]), scan
    coder = cuda_codec.CudaCoder(pc, cfg, device=cuda_device)
    res = coder.encode_batch(syms.reshape((2,) + shape), centers)
    pb = cuda_codec.parse_batch([r.bitstream for r in res],
                                lambda s: ck.build_schedule(s).stream_cap,
                                lambda s: ck.lane_totals(ck.build_schedule(s)))
    streams, states, thresh = cuda_codec.upload_parsed(pb, sched.stream_cap, cuda_device)
    out = ck.wavefront_forward(ck.MODE_DECODE, w, shape, force=force, streams=streams,
                               init_states=states, thresh=thresh)
    assert torch.equal(out, syms)


def test_k5_kf64_encode_equals_scan_plain_and_roundtrips(cuda_device):
    """K = 5 at kf = 64 (`pc base` with arch_param__k = 64: 439 KB of weights
    in device memory): the layer-parallel encode equals the plane-by-plane
    scan, the CPU plain version up to the flip allowance, and a CRC-verified
    round trip recovers the symbols."""
    shape = (3, 12, 20)
    pc, cfg = _planar_pc(cuda_device, K=5, kf=64, seed=14)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    coder = planar_codec.PlanarCoder(pc, cfg, device=cuda_device)
    _, fold = coder._prepare(shape, centers)
    assert plk.weights_in_device(fold.top, shape, 5, scan=True)
    assert plk.weights_in_device(fold.top, shape, 5, scan=False)
    syms = torch.from_numpy(np.random.RandomState(14).randint(0, 6, (2,) + shape)).int()
    syms = syms.to(cuda_device)
    fk, sk = coder.encode_tables(syms, fold)
    fs, ss = coder.encode_tables_scan(syms, fold)
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    cpu = planar_codec.PlanarCoder(pc.cpu(), cfg, device='cpu')
    _, fold_cpu = cpu._prepare(shape, centers.cpu())
    fp, sp = cpu.encode_tables(syms.cpu(), fold_cpu)
    assert ((fk.cpu() != fp) | (sk.cpu() != sp)).sum().item() <= int(5e-3 * syms.numel() * 2)
    pc.to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    res = lc.encode_batch(syms, centers)
    assert torch.equal(lc.decode_batch([r.bitstream for r in res], centers,
                                       verify=True).long(), syms.long())


@pytest.mark.parametrize('force', [1, 3])
def test_k5_weight_placement_keeps_the_bits(cuda_device, force):
    """K = 5, kf = 24 (the compile-time instance, weights in shared memory by
    default): the scan and a level pass with the weights in device memory
    (force 1; 3: and the generic instance) give the default path's bits."""
    shape = (3, 12, 20)
    coder, sched, fold, syms, bias = _plane_inputs(cuda_device, shape, K=5, plane=2, kf=24)
    for force_l in (0, force):
        assert plk.weights_in_device(fold.top, shape, 5, force=force_l) == bool(force_l)
    tp = syms[:, 2].contiguous()
    ref = plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, 5, bias, true_plane=tp)
    out = plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, 5, bias, true_plane=tp,
                            force=force)
    assert torch.equal(out.fsel, ref.fsel) and torch.equal(out.ssel, ref.ssel)
    for a, b in zip(out.acts, ref.acts):
        assert torch.equal(a, b)
    src = ref.q.reshape((2,) + sched.grids[0])
    lv = plk.level_forward(1, fold.top, shape, 5, src, bias[0])
    assert torch.equal(plk.level_forward(1, fold.top, shape, 5, src, bias[0], force=force), lv)


def _planar_pc(device, K=5, kf=8, L=6, seed=0):
    cfg, _ = config_lib.parse_spec('base', 'pc')
    cfg = cfg.replace(kernel_size=K, arch_param__k=kf)
    return pcl.init_params(pcl.ProbClassifier(cfg, L, device=device), seed), cfg


def _plane_inputs(device, shape, K=5, b=2, seed=0, plane=2, kf=8):
    """Bias rows of plane ``plane`` with real history (planes below it
    encoded through the plain version), the fold and the symbols."""
    pc, cfg = _planar_pc(device, K=K, kf=kf, seed=seed)
    centers = torch.linspace(-2, 2, 6, device=device)
    coder = planar_codec.PlanarCoder(pc, cfg, device=device)
    sched, fold = coder._prepare(shape, centers)
    rng = np.random.RandomState(seed)
    syms = torch.from_numpy(rng.randint(0, 6, (b,) + shape)).int().to(device)
    hist = coder._history(fold, sched, b)
    for d in range(plane):
        out = plk.plane_forward_plain(plk.MODE_ENCODE, fold.top, shape, K,
                                      coder.bias_rows(fold, hist),
                                      true_plane=syms[:, d].contiguous())
        coder._push(hist, out)
    return coder, sched, fold, syms, coder.bias_rows(fold, hist)


@pytest.mark.parametrize('K,shape', [(5, (4, 8, 8)), (5, (3, 12, 20)), (3, (3, 5, 9))])
def test_plane_forward_kernel_matches_plain(cuda_device, K, shape):
    """Kernel 5 in both modes against its plain version on one plane with
    real history: encode tables and activations equal (the plain version
    repeats the kernel's roundings; up to 0.1% boundary flips tolerated for
    expf vs torch.exp), and decode recovers the plane from a stream the
    plain reverse encoder wrote, with the same end state."""
    plane = min(2, shape[0] - 1)
    coder, sched, fold, syms, bias = _plane_inputs(cuda_device, shape, K=K, plane=plane)
    true_plane = syms[:, plane].contiguous()
    before = build.LAUNCHES['plane_forward_encode_scan']
    ok = plk.plane_forward(plk.MODE_ENCODE, fold.top, shape, K, bias, true_plane=true_plane)
    assert build.LAUNCHES['plane_forward_encode_scan'] == before + 1
    op = plk.plane_forward_plain(plk.MODE_ENCODE, fold.top, shape, K, bias,
                                 true_plane=true_plane)
    act = torch.from_numpy(sched.idx_cm < shape[1] * shape[2]).to(cuda_device)
    flips = ((ok.fsel != op.fsel) | (ok.ssel != op.ssel)) & act
    assert flips.sum().item() <= int(1e-3 * act.sum().item() * 2)
    for a, b in zip(ok.acts + (ok.q,), op.acts + (op.q,)):
        assert (a - b).abs().max().item() <= 1e-6
    # Decode: one plane's stream from the plain reverse encoder (a one-plane
    # volume has the same (step, lane) rows as this plane).
    one = (1,) + shape[1:]
    words, n, st, _ = plk.plane_reverse_plain(op.fsel, op.ssel, one, K, rans.RANS_L)
    streams = torch.zeros(2, sched.stream_cap, dtype=torch.int32, device=cuda_device)
    for i in range(2):
        streams[i, :n[i]] = words[i, :n[i]].flip(0)
    gptr = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    thresh = torch.full((2, plk.R), 1 << 30, dtype=torch.int32, device=cuda_device)
    dk = plk.plane_forward(plk.MODE_DECODE, fold.top, shape, K, bias, streams=streams,
                           states=st, gptr=gptr, thresh=thresh)
    dp = plk.plane_forward_plain(plk.MODE_DECODE, fold.top, shape, K, bias,
                                 streams=streams, states=st, gptr=gptr, thresh=thresh)
    assert torch.equal(dk.syms, true_plane) and torch.equal(dp.syms, true_plane)
    assert torch.equal(dk.states, dp.states) and torch.equal(dk.gptr, dp.gptr)
    assert torch.equal(dk.gptr, n)


@pytest.mark.parametrize('x0', [1, rans.RANS_L])
def test_plane_reverse_kernel_byte_identical(cuda_device, x0):
    shape, K = (3, 8, 8), 5
    pc, cfg = _planar_pc(cuda_device, seed=2)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    coder = planar_codec.PlanarCoder(pc, cfg, device=cuda_device)
    _, fold = coder._prepare(shape, centers)
    syms = torch.from_numpy(np.random.RandomState(2).randint(0, 6, (3,) + shape)).int()
    fsel, ssel = coder.encode_tables(syms.to(cuda_device), fold)
    before = build.LAUNCHES['plane_reverse']
    wk, nk, stk, kk = plk.plane_reverse(fsel, ssel, shape, K, x0)
    assert build.LAUNCHES['plane_reverse'] == before + 1
    wp, npl, stp, kp = plk.plane_reverse_plain(fsel, ssel, shape, K, x0)
    assert torch.equal(nk, npl)
    for i in range(3):
        assert torch.equal(wk[i, :nk[i]], wp[i, :npl[i]])
    assert torch.equal(stk, stp) and torch.equal(kk, kp)


# ---------------------------------------------------------------------------
# Kernels 3 and 6: the list-driven reverse encoder on synthetic tables
# ---------------------------------------------------------------------------

def _reverse_case(kind, shape):
    """(active (rows, W) bool, run(fsel, ssel, x0, prof), plain(fsel, ssel,
    x0), cap, rlist) of kernel 3 at a K=3 latent or kernel 6 at a K=5 one."""
    if kind == 'k3':
        sched = ck.build_schedule(shape)
        active = sched.idx_cm < int(np.prod(shape))
        return (active, lambda f, s, x0, prof=None: ck.rans_reverse(f, s, shape, x0, prof),
                lambda f, s, x0: ck.rans_reverse_plain(f, s, shape, x0), sched.stream_cap,
                lambda dev: ck.device_reverse_list(shape, str(dev)))
    sched = planar.build_planar_schedule(shape, 5)
    return (plk._full_active(sched),
            lambda f, s, x0, prof=None: plk.plane_reverse(f, s, shape, 5, x0, prof),
            lambda f, s, x0: plk.plane_reverse_plain(f, s, shape, 5, x0), sched.stream_cap,
            lambda dev: plk._device_reverse_list(shape, 5, str(dev)))


def _reverse_tables(active, b, seed, device):
    """Valid (f, s) on active lanes (f log-uniform in [1, 65530], s + f <=
    65536), garbage on inactive ones: 0, negatives, values past 2^16."""
    rng = np.random.RandomState(seed)
    size = (b,) + active.shape
    f = np.exp(rng.uniform(0, np.log(65530), size)).astype(np.int64).clip(1, 65530)
    s = (rng.uniform(0, 1, size) * (65537 - f)).astype(np.int64).clip(0, 65536 - f)
    junk = np.array([0, -1, -7, -65536, 65536, 1 << 20, 2 ** 31 - 1, -2 ** 31], np.int64)
    f = np.where(active, f, junk[rng.randint(0, len(junk), size)])
    s = np.where(active, s, junk[rng.randint(0, len(junk), size)])
    return (torch.from_numpy(f.astype(np.int32)).to(device),
            torch.from_numpy(s.astype(np.int32)).to(device))


def _same_streams(a, b, images):
    wa, na, sa, ka = a
    wb, nb, sb, kb = b
    for i, j in images:
        assert int(na[i]) == int(nb[j])
        assert torch.equal(wa[i, :na[i]], wb[j, :nb[j]])
        assert torch.equal(sa[i], sb[j]) and torch.equal(ka[i], kb[j])


# (9, 5, 6) has 226 non-empty sub-iterations, (3, 12, 20) 357 rows: neither a
# multiple of the 32-entry tile; (3, 8, 8) has 192, a multiple.
@pytest.mark.parametrize('x0', [1, rans.RANS_L])
@pytest.mark.parametrize('kind,shape', [('k3', (9, 5, 6)), ('k3', (6, 10, 12)),
                                        ('k6', (3, 12, 20)), ('k6', (3, 8, 8))])
def test_reverse_kernel_list_any_batch(cuda_device, kind, shape, x0):
    """Kernels 3 and 6 against their plain version byte for byte at B = 17
    on tables whose inactive entries hold garbage; B = 1 and B = 3 runs give
    each image the outputs it had at B = 17; a run with the clock profile
    gives the same outputs and counts the listed sub-iterations."""
    active, run, plain, _, rlist = _reverse_case(kind, shape)
    fsel, ssel = _reverse_tables(active, 17, seed=11, device=cuda_device)
    out = run(fsel, ssel, x0)
    _same_streams(out, plain(fsel, ssel, x0), [(i, i) for i in range(17)])
    for b in (1, 3):
        _same_streams(run(fsel[:b].contiguous(), ssel[:b].contiguous(), x0), out,
                      [(i, i) for i in range(b)])
    prof = torch.zeros(17, ck.REVERSE_PROF, dtype=torch.int64, device=cuda_device)
    _same_streams(run(fsel, ssel, x0, prof), out, [(i, i) for i in range(17)])
    assert (prof[:, 2] == rlist(cuda_device).E).all()
    assert (prof[:, 0] > 0).all() and (prof >= 0).all()
    assert (prof[:, 1] <= prof[:, 0]).all()


@pytest.mark.parametrize('kind,shape', [('k3', (9, 5, 6)), ('k6', (3, 12, 20))])
def test_reverse_kernel_drops_words_past_cap(cuda_device, kind, shape):
    """A cap below the word count: the words that fit are the plain
    version's, the rest are dropped but counted in n_words."""
    active, run, _, stream_cap, rlist = _reverse_case(kind, shape)
    fsel, ssel = _reverse_tables(active, 3, seed=12, device=cuda_device)
    n_full = run(fsel, ssel, 1)[1]
    cap = int(n_full.min()) // 2
    wk, nk, sk, kk = ck.reverse_launch(fsel, ssel, rlist(cuda_device), cap, 1)
    rows, masks = ck.reverse_list(active)
    wp, np_, sp, kp = ck.reverse_plain_list(fsel, ssel, rows, masks, cap, 1)
    assert torch.equal(nk, n_full) and torch.equal(nk, np_) and (nk > cap).all()
    assert torch.equal(wk, wp) and torch.equal(sk, sp) and torch.equal(kk, kp)


def test_planar_roundtrip_through_kernels(cuda_device):
    shape = (4, 8, 8)
    pc, cfg = _planar_pc(cuda_device, seed=3)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    syms = torch.from_numpy(np.random.RandomState(3).randint(0, 6, (2,) + shape)).to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    build.reset_launches()
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers)
    assert torch.equal(dec.long(), syms.long())
    assert build.LAUNCHES['plane_forward_encode'] == 5      # 4 levels + the tables
    assert build.LAUNCHES['plane_forward_encode_scan'] == 0
    assert build.LAUNCHES['plane_forward_decode'] == shape[0]
    assert build.LAUNCHES['plane_reverse'] == 1
    assert build.LAUNCHES['wavefront_forward_encode'] == 0
    assert all(codec.stream_impl_id(r.bitstream) == codec.IMPL_CUDA_PLANAR for r in res)
    assert all(codec.deserialize_stream(r.bitstream)[4] is not None for r in res)


def test_planar_streams_batch_invariant(cuda_device):
    """Encode 3 images, decode each stream alone: the bytes equal a B=1
    encode of that image (bias rows are a fixed function of one image)."""
    shape = (3, 16, 24)
    pc, cfg = _planar_pc(cuda_device, seed=4)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    syms = torch.from_numpy(np.random.RandomState(4).randint(0, 6, (3,) + shape)).to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    res = lc.encode_batch(syms, centers)
    for i in range(3):
        assert lc.encode_batch(syms[i:i + 1], centers)[0].bitstream == res[i].bitstream
        dec = lc.decode_batch([res[i].bitstream], centers)
        assert torch.equal(dec[0].long(), syms[i].long())


@pytest.mark.parametrize('K,kf,shape', [
    (5, 24, (4, 8, 8)), (5, 24, (3, 12, 20)), (5, 24, (2, 5, 9)),   # compile-time widths
    (5, 8, (3, 12, 20)), (3, 24, (3, 5, 9)), (7, 24, (2, 6, 7))])   # generic instance
def test_planar_parallel_encode_equals_scan(cuda_device, K, kf, shape):
    """Kernel 5's layer-parallel encode (4 level launches + the tables)
    equals its plane-by-plane teacher-forced scan on every plane, and the
    plain layer-at-a-time version up to the flip allowance."""
    pc, cfg = _planar_pc(cuda_device, K=K, kf=kf, seed=8)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    coder = planar_codec.PlanarCoder(pc, cfg, device=cuda_device)
    _, fold = coder._prepare(shape, centers)
    syms = torch.from_numpy(np.random.RandomState(8).randint(0, 6, (2,) + shape)).int()
    syms = syms.to(cuda_device)
    build.reset_launches()
    fk, sk = coder.encode_tables(syms, fold)
    assert build.LAUNCHES['plane_forward_encode'] == 5
    fs, ss = coder.encode_tables_scan(syms, fold)
    assert build.LAUNCHES['plane_forward_encode_scan'] == shape[0]
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    cpu = planar_codec.PlanarCoder(pc.cpu(), cfg, device='cpu')
    _, fold_cpu = cpu._prepare(shape, centers.cpu())
    fp, sp = cpu.encode_tables(syms.cpu(), fold_cpu)
    # CPU vs card: the bias-row convolutions and exp differ by an ulp.
    flips = (fk.cpu() != fp) | (sk.cpu() != sp)
    assert flips.sum().item() <= int(5e-3 * syms.numel() * 2)


@pytest.mark.parametrize('b', [1, 3, 17])
def test_planar_decode_any_batch(cuda_device, b):
    shape = (3, 12, 20)
    pc, cfg = _planar_pc(cuda_device, kf=24, seed=9)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    syms = torch.from_numpy(np.random.RandomState(9).randint(0, 6, (b,) + shape)).to(cuda_device)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    res = lc.encode_batch(syms, centers)
    assert torch.equal(lc.decode_batch([r.bitstream for r in res], centers).long(), syms.long())
    assert lc.encode_batch(syms[b - 1:], centers)[0].bitstream == res[b - 1].bitstream


# ---------------------------------------------------------------------------
# Kernel 1: vector body, scalar head and tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [1, 3, 4, 5, 4 * 1000 + 1, 4 * 1000 + 3])
@pytest.mark.parametrize('offset', [0, 1, 2, 3])
@pytest.mark.parametrize('num_centers', [6, 9])
def test_quantize_kernel_any_length_and_alignment(cuda_device, n, offset, num_centers):
    """Kernel 1 on a view that starts `offset` floats past a 16-byte boundary
    and at lengths that are and are not a multiple of 4: symbols and qhard
    equal the plain version's, qsoft within the tolerance of
    test_quantize_kernel_matches_plain; the outputs share x's offset."""
    rng = np.random.RandomState(n + offset)
    base = torch.from_numpy(rng.randn(n + 8).astype(np.float32) * 2).to(cuda_device)
    x = base[offset:offset + n]
    assert x.data_ptr() % 16 == 4 * offset
    c = torch.from_numpy(np.sort(rng.uniform(-2, 2, num_centers)).astype(np.float32))
    c = c.to(cuda_device)
    qs, qh, sym = qk.quantize_fwd(x, c)
    ps, ph, psym = qk.quantize_plain(x, c)
    torch.cuda.synchronize()
    assert all(t.data_ptr() % 16 == 4 * offset for t in (qs, qh, sym))
    assert torch.equal(sym, psym) and torch.equal(qh, ph)
    assert (qs - ps).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# Training (kernel 7)
# ---------------------------------------------------------------------------

def test_quantize_bwd_one_launch_and_the_same_bits_on_two_streams(cuda_device):
    """Kernel 7 is one launch a call (the ticket's last block adds the rows):
    dcenters is bit-equal over two calls on one stream and on a second
    stream, each stream has its own scratch, and the counter is 0 again
    after every call."""
    x, c, g, gh = _bwd_inputs(cuda_device, (30, 20, 20, 32), seed=3)
    before = build.LAUNCHES['quantize_bwd']
    dx, dc = qk.quantize_bwd(x, c, g, gh)
    assert build.LAUNCHES['quantize_bwd'] == before + 1
    dx2, dc2 = qk.quantize_bwd(x, c, g, gh)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dx3, dc3 = qk.quantize_bwd(x, c, g, gh)
    torch.cuda.synchronize()
    assert torch.equal(dc, dc2) and torch.equal(dc, dc3)
    assert torch.equal(dx, dx2) and torch.equal(dx, dx3)
    keys = [k for k in qk._bwd_scratch if k[0] == x.device.index]
    assert {k[1] for k in keys} >= {torch.cuda.current_stream().cuda_stream, side.cuda_stream}
    assert all(qk._bwd_scratch[k][1].item() == 0 for k in keys)
    px, pc_ = qk.quantize_bwd_plain(x, c, g, gh)
    assert (dx - px).abs().max().item() <= 1e-5 * max(1.0, px.abs().max().item())
    assert (dc - pc_).abs().max().item() <= 4e-5 * float(x.numel()) ** 0.5


@pytest.mark.parametrize('offset', [1, 3])
def test_quantize_bwd_unaligned_view(cuda_device, offset):
    """An x that starts off a 16-byte boundary (all scalar where g is
    aligned otherwise): dx and dcenters within the plain tolerance."""
    x, c, g, _ = _bwd_inputs(cuda_device, (4 * 997 + offset,), seed=4)
    xs = x[offset:]
    gs = g[:xs.numel()]
    dx, dc = qk.quantize_bwd(xs, c, gs, None)
    px, pc_ = qk.quantize_bwd_plain(xs, c, gs, None)
    assert (dx - px).abs().max().item() <= 1e-5 * max(1.0, px.abs().max().item())
    assert (dc - pc_).abs().max().item() <= 4e-5 * float(xs.numel()) ** 0.5


def _bwd_inputs(device, shape, num_centers=6, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (mk(rng.randn(*shape) * 2), mk(np.sort(rng.uniform(-2, 2, num_centers))),
            mk(rng.randn(*shape)), mk(rng.randn(*shape)))


@pytest.mark.parametrize('shape,num_centers', [
    ((30, 20, 20, 32), 6), ((3, 17, 29, 5), 6), ((7,), 6),
    ((3, 17, 29, 5), 8), ((3, 17, 29, 5), 9), ((3, 17, 29, 5), 32)])  # both template widths
@pytest.mark.parametrize('use_g,use_gh', [(True, True), (True, False), (False, True)])
def test_quantize_bwd_kernel_matches_plain(cuda_device, shape, num_centers, use_g, use_gh):
    """Kernel 7 against its plain version in float32 and float64; absent
    cotangents go in as null pointers; two launches give bit-equal sums."""
    x, c, g, gh = _bwd_inputs(cuda_device, shape, num_centers)
    g, gh = (g if use_g else None), (gh if use_gh else None)
    before = build.LAUNCHES['quantize_bwd']
    dx, dc = qk.quantize_bwd(x, c, g, gh)
    assert build.LAUNCHES['quantize_bwd'] == before + 1
    dx2, dc2 = qk.quantize_bwd(x, c, g, gh)
    torch.cuda.synchronize()
    assert torch.equal(dc, dc2) and torch.equal(dx, dx2)
    px, pc_ = qk.quantize_bwd_plain(x, c, g, gh)
    d = lambda t: None if t is None else t.double()
    rx, rc = qk.quantize_bwd_plain(x.double(), c.double(), d(g), d(gh))
    # expf vs torch.exp and FMA contraction on |dx| <~ 10, with cancelling terms.
    assert (dx - px).abs().max().item() <= 1e-5 * max(1.0, px.abs().max().item())
    assert (dx.double() - rx).abs().max().item() <= 1e-5 * max(1.0, rx.abs().max().item())
    # Sums of up to 384,000 terms: the kernel's tree is held to the float64
    # referee at 2e-5 of the sum of the terms' magnitudes.
    n = x.numel()
    scale = max(1.0, float(n) ** 0.5)
    assert (dc.double() - rc).abs().max().item() <= 2e-5 * scale
    assert (dc - pc_).abs().max().item() <= 4e-5 * scale


def test_quantize_under_autograd_reaches_the_encoder(cuda_device):
    """quantize() on a CUDA tensor is differentiable: kernel 1 forward and
    kernel 7 backward under QuantizeFn give x and the centers the gradients
    the plain pair gives on the CPU."""
    x, c, _, _ = _bwd_inputs(cuda_device, (2, 8, 8, 4), seed=1)

    def grads(xv, cv):
        xv, cv = xv.clone().requires_grad_(), cv.clone().requires_grad_()
        out = quantizer_lib.quantize(xv, cv)
        ((out.qbar * torch.cos(out.qbar)).sum() + (out.qsoft ** 2).sum()
         + (out.qhard ** 2).sum()).backward()
        return xv.grad, cv.grad

    build.reset_launches()
    gx, gc = grads(x, c)
    assert build.LAUNCHES['quantize'] == 1 and build.LAUNCHES['quantize_bwd'] == 1
    assert gx is not None and gx.abs().max().item() > 0
    cx, cc = grads(x.cpu(), c.cpu())
    assert (gx.cpu() - cx).abs().max().item() <= 1e-5
    # sums of 512 terms of magnitude ~1e2-1e3: relative to the largest
    assert (gc.cpu() - cc).abs().max().item() <= 1e-5 * cc.abs().max().item()


def test_full_model_step_kernel_vs_plain_gradients(cuda_device, monkeypatch):
    """One forward + backward of a small model on the card with kernel 7,
    and one with the plain backward on the same weights and batch."""
    ae_cfg, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae_cfg = ae_cfg.replace(arch_param_B=1, num_chan_bn=8, batch_size=4, crop_size=(64, 64))
    t = trainer_lib.Trainer(ae_cfg, pc_cfg.replace(arch_param__k=8), device=cuda_device)
    state = t.init_state(0)
    batch = (np.random.RandomState(0).rand(4, 64, 64, 3) * 255).astype(np.uint8)
    snapshot = {k: v.clone() for k, v in state.ae.state_dict().items()}

    def grads():
        state.ae.load_state_dict(snapshot)       # the forward moves the BN statistics
        state.optimizer.zero_grad()
        total, _ = t.loss_fn(state, batch)
        total.backward()
        return {n: p.grad.clone() for n, p in
                list(state.ae.named_parameters()) + list(state.pc.named_parameters())}

    # cuDNN's default backward algorithms sum in an order that changes from
    # run to run (two runs of the same code part by more than the tolerance
    # below on some leaves); with its deterministic ones what differs is
    # the quantizer's backward alone.
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        build.reset_launches()
        g_kernel = grads()
        assert build.LAUNCHES['quantize_bwd'] == 1
        monkeypatch.setattr(qk, 'quantize_bwd', qk.quantize_bwd_plain)
        g_plain = grads()
    finally:
        torch.backends.cudnn.deterministic = was
    assert build.LAUNCHES['quantize_bwd'] == 1
    assert g_kernel['encoder.h1.weight'].abs().max().item() > 0
    for n in g_kernel:
        scale = g_plain[n].abs().max().item()
        # the kernel's roundings (expf, FMA contraction, its summation tree)
        assert (g_kernel[n] - g_plain[n]).abs().max().item() <= 1e-3 * scale + 1e-12, n


# ---------------------------------------------------------------------------
# The codec's submit / finish split: no wait for the card in a submit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('K', [3, 5])
def test_submit_does_not_wait_for_the_card(cuda_device, K):
    """Encode and decode submits, with symbols on the card and as numpy and
    with host centers, run under torch.cuda.set_sync_debug_mode('error'):
    none of their calls synchronizes with the card. Two handles outstanding
    finish to encode_batch's streams; a bad symbol on the card raises at
    finish; device_out=False gives the host np.int32 symbols."""
    shape = (6, 10, 12) if K == 3 else (3, 12, 20)
    pc, cfg = _pc(cuda_device, kf=8, seed=20) if K == 3 else _planar_pc(cuda_device, seed=20)
    lc = codec.LatentCodec(pc, cfg, device=cuda_device)
    centers = np.linspace(-2, 2, 6).astype(np.float32)
    syms = torch.from_numpy(np.random.RandomState(20).randint(0, 6, (4,) + shape)).int()
    syms_dev = syms.to(cuda_device)
    ref = [r.bitstream for r in lc.encode_batch(syms_dev, centers)]   # builds the caches
    lc.decode_batch(ref, centers)
    bad = syms_dev.clone()
    bad[0, 0, 0, 0] = 6
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        h1 = lc.encode_batch_submit(syms_dev[:2], centers)
        h2 = lc.encode_batch_submit(syms[2:].numpy(), centers)
        hb = lc.encode_batch_submit(bad, centers)
        d1 = lc.decode_batch_submit(ref, centers)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [r.bitstream for r in lc.encode_batch_finish(h1) + lc.encode_batch_finish(h2)] == ref
    with pytest.raises(ValueError, match='must lie in'):
        lc.encode_batch_finish(hb)
    out = lc.decode_batch_finish(d1, device_out=False)
    assert isinstance(out, np.ndarray) and out.dtype == np.int32
    np.testing.assert_array_equal(out, syms.numpy())


@pytest.mark.parametrize('pc_spec', ['cvpr/res_shallow', 'base'])
def test_validate_real_bpp_and_tail_batches_on_card(cuda_device, tmp_path, pc_spec):
    """The validation path on the card at a small size: a tail batch padded
    to eval_batch gives each image the results it gets in a full batch
    (one cuDNN problem shape), and validate() with real_bpp round-trips
    every bucket through the kernels (K=3: kernels 1-3; K=5: 1, 5, 6)."""
    from PIL import Image
    from imgcomp_cvpr_tpu_torch.data.images_iterator import ImagesIterator
    from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
    from imgcomp_cvpr_tpu_torch.eval.val_files import ValidationDirs
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ael
    from imgcomp_cvpr_tpu_torch.training import checkpoint as ckpt_lib
    from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib
    ae_cfg, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = config_lib.parse_spec(pc_spec, 'pc')
    em = validate_lib.EvalModel(ae_cfg.replace(arch_param_B=1, num_chan_bn=8),
                                pc_cfg.replace(arch_param__k=8), device=cuda_device)
    ael.init_params(em.ae, 0)
    pcl.init_params(em.pc, 1)
    rng = np.random.RandomState(0)
    imgs = [(rng.rand(64, 96, 3) * 255).astype(np.uint8) for _ in range(5)]
    full = em.fetch_many(imgs[:4], pad_batch_to=4)
    tail = em.fetch_many(imgs[:3], pad_batch_to=4)
    for a, b in zip(tail, full):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(tmp_path / f'im{i}.png')
    log_dir = logdir_lib.create_unique_log_dir(['a', 'b'], str(tmp_path / 'logs'))
    ckpt_lib.Saver(logdir_lib.ckpt_dir_for_log_dir(log_dir)).save(
        {'model': {'ae': em.ae.state_dict(), 'pc': em.pc.state_dict()}}, 1)
    vd = ValidationDirs(logdir_lib.ckpt_dir_for_log_dir(log_dir), str(tmp_path / 'logs'), 'x')
    it = ImagesIterator(sorted(str(p) for p in tmp_path.glob('*.png')), 'x')
    build.reset_launches()
    validate_lib.validate(vd, it, validate_lib.OutputFlags(real_bpp=True, eval_batch=4),
                          eval_model=em)
    torch.cuda.synchronize()
    names = (('wavefront_forward_encode', 'rans_reverse', 'wavefront_forward_decode')
             if pc_spec == 'cvpr/res_shallow'
             else ('plane_forward_encode', 'plane_reverse', 'plane_forward_decode'))
    assert build.LAUNCHES['quantize'] == 2 and all(build.LAUNCHES[k] >= 2 for k in names)
    assert vd.get_validated_checkpoints() == [1]


# ---------------------------------------------------------------------------
# Kernel 2 at bf16 and f8 (container prec 1 and 2); the entry points
# ---------------------------------------------------------------------------

# kf = 24 at L = 6 (compile-time widths; weights in shared memory, and in
# device memory by force), kf = 64 (device memory) and kf = 8 (generic).
@pytest.mark.parametrize('kf,force', [(24, 0), (24, ck.FORCE_WDEV), (64, 0), (8, 0)])
@pytest.mark.parametrize('prec', ['bf16', 'f8'])
def test_precisions_match_plain_on_card(cuda_device, prec, kf, force):
    """At each precision the layer-parallel tables equal the scan's mode-1
    tables and the plain version's (on the card) on every entry, the decode
    recovers the symbols, and the precision's own counters count."""
    shape = (6, 10, 12)
    _, _, _, w, syms = _k3_case(cuda_device, shape, kf, 6, 2, seed=7)
    p = ck.prec_id(prec)
    build.reset_launches()
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, prec=prec,
                                  force=force)
    fs, ss = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms, prec=prec,
                                  scan=True, force=force)
    fp, sp = ck.wavefront_encode_plain(w, shape, syms, prec=prec)
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    f0, _ = ck.wavefront_forward(ck.MODE_ENCODE, w, shape, true_syms=syms)
    assert not torch.equal(f0, fk)
    sched = ck.build_schedule(shape)
    wd, nw, st, k = ck.rans_reverse(fk, sk, shape, 1)
    streams = torch.zeros(2, sched.stream_cap, dtype=torch.int32, device=cuda_device)
    for i in range(2):
        streams[i, :nw[i]] = wd[i, :nw[i]].flip(0)
    thresh = (torch.from_numpy(ck.lane_totals(sched)).to(cuda_device)[None] - k).int()
    dec = ck.wavefront_forward(ck.MODE_DECODE, w, shape, streams=streams, init_states=st,
                               thresh=thresh.contiguous(), prec=prec, force=force)
    assert torch.equal(dec, syms)
    for base in ('wavefront_forward_encode', 'wavefront_forward_encode_scan',
                 'wavefront_forward_decode'):
        assert build.LAUNCHES[ck.launch_name(base, p)] == 1
    for c in (1, 3):                     # clusters of any size: the same symbols
        assert torch.equal(ck.wavefront_forward(
            ck.MODE_DECODE, w, shape, streams=streams, init_states=st,
            thresh=thresh.contiguous(), prec=prec, force=force, cluster=c), syms)
    assert build.LAUNCHES['wavefront_forward_encode'] == 1     # the f32 call above


def test_round_operand_on_card_matches_cpu(cuda_device):
    x = torch.randn(1 << 18) * 10 ** torch.empty(1 << 18).uniform_(-5, 3)
    x[:4] = torch.tensor([470.0, -1000.0, 464.0, float('inf')])
    for kind in ('bf16', 'e4m3'):
        a = ck.round_operand(x, kind)
        b = ck.round_operand(x.to(cuda_device), kind).cpu()
        assert ((a == b) | (a.isnan() & b.isnan())).all()


def test_precision_codec_round_trip_on_card(cuda_device):
    """LatentCodec(prec=...) on the card: each precision's streams carry
    their byte and decode bit-exactly, through a coder of any precision."""
    pc, cfg, centers, _, _ = _k3_case(cuda_device, (4, 6, 7), 8, 6, 2, seed=3)
    syms = torch.from_numpy(np.random.RandomState(3).randint(0, 6, (3, 4, 6, 7))).to(cuda_device)
    any_prec = codec.LatentCodec(pc, cfg, device=cuda_device)
    for prec in ('f32', 'bf16', 'f8'):
        res = codec.LatentCodec(pc, cfg, device=cuda_device, prec=prec).encode_batch(
            syms, centers)
        assert {codec.stream_prec(r.bitstream) for r in res} == {ck.prec_id(prec)}
        dec = any_prec.decode_batch([r.bitstream for r in res], centers)
        assert torch.equal(dec.long(), syms.long())


def test_entry_points_on_card(cuda_device, capsys):
    import graft_entry_torch as entry_lib
    fn, (ae, pc, x) = entry_lib.entry()
    out, bpp = fn(ae, pc, x)
    assert out.device.type == 'cuda' and tuple(out.shape) == (1, 64, 64, 3)
    assert torch.isfinite(out).all() and np.isfinite(float(bpp))
    entry_lib.dryrun_multichip(1)
    assert 'dryrun_multichip(1): ok' in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Non-finite activations and logits (kernels 2 and 5 against their plain
# versions; tests/test_torch_nonfinite.py holds the plain versions to JAX)
# ---------------------------------------------------------------------------

def test_cdf_on_nonfinite_logits_matches_plain(cuda_device):
    """csrc/cdf.cuh through kernel 5's table pass on logits holding NaN,
    +inf and -inf: the plain version's tables on every entry. A column with
    a NaN or a +inf is freq 1 for every symbol ((int)floorf(NaN) is 0, and
    no symbol takes the deficit)."""
    shape, L = (3, 12, 20), 6
    pc, cfg = _planar_pc(cuda_device)
    coder = planar_codec.PlanarCoder(pc, cfg, device=cuda_device)
    _, fold = coder._prepare(shape, torch.linspace(-2, 2, L, device=cuda_device))
    rng = np.random.RandomState(0)
    P = 2 * shape[0]
    lg = (rng.randn(P, shape[1], shape[2], L) * 4).astype(np.float32)
    for v, cells in zip((np.nan, np.inf, -np.inf), rng.rand(3, P, shape[1], shape[2]) < 0.1):
        lg[cells, rng.randint(0, L, int(cells.sum()))] = v
    lg = torch.from_numpy(lg).to(cuda_device)
    true = torch.from_numpy(rng.randint(0, L, (P,) + shape[1:])).int().to(cuda_device)
    fk, sk = plk.plane_tables(fold.top, lg, true, shape, 5)
    fp, sp = plk.plane_tables_plain(lg, true, shape, 5)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    assert int((ck.logits_to_cdf(lg)[0] == 1).all(-1).sum()) > 100


def test_k3_f8_activation_past_464_kernel_equals_plain_and_roundtrips(cuda_device):
    """Layer 1's hottest channel scaled to 1.25 x 464 at its peak: the f8
    ring rounds the largest activations to NaN and the ReLU keeps it.
    Kernel 2's f8 layer-parallel tables equal its scan's and the plain
    version's on every entry, some columns are all ones, and the f8 codec
    round-trips."""
    shape = (4, 6, 7)
    pc, cfg = _pc(cuda_device)
    centers = torch.linspace(-2, 2, 6, device=cuda_device)
    rng = np.random.RandomState(0)
    syms = torch.from_numpy(rng.randint(0, 6, (2,) + shape)).int().to(cuda_device)
    flat = syms.reshape(2, -1).contiguous()
    fw = cuda_codec.fold_weights(pc, centers)
    taps = ck.device_tables(shape, 'cuda').taps[0].long()
    src = torch.cat([fw.centers[flat.long()], fw.pad.expand(2, 1)], 1)[:, :, None]
    peak = ck.layer_all_cells(src, taps, fw.w1, fw.b1).amax((0, 1))
    ch = int(peak.argmax())
    with torch.no_grad():
        for t in (pc.net.conv0.weight, pc.net.conv0.bias):
            t[ch] *= 1.25 * 464 / float(peak[ch])
    fw = cuda_codec.fold_weights(pc, centers)
    fk, sk = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=flat, prec='f8')
    fs, ss = ck.wavefront_forward(ck.MODE_ENCODE, fw, shape, true_syms=flat, prec='f8',
                                  scan=True)
    (fp, sp), logits = ck.wavefront_encode_plain(fw, shape, flat, prec='f8',
                                                 return_logits=True)
    assert torch.equal(fk, fs) and torch.equal(sk, ss)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    assert (ck.logits_to_cdf(logits)[0] == 1).all(-1).any()
    lc = codec.LatentCodec(pc, cfg, device=cuda_device, prec='f8')
    res = lc.encode_batch(syms, centers)
    dec = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
    assert torch.equal(dec.long(), syms.long())


# ---------------------------------------------------------------------------
# The autoencoder's eval-mode conv epilogue (csrc/ae_epilogue.cu)
# ---------------------------------------------------------------------------

def _same_bits(a, b):
    """Equal bit for bit, NaN payloads aside (a NaN must stay a NaN)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits)[~nan], b.view(bits)[~nan])


@pytest.mark.parametrize('layout', ['packed', 'crop'])
@pytest.mark.parametrize('nres', [0, 1, 2])
@pytest.mark.parametrize('act', [True, False])
@pytest.mark.parametrize('c', [3, 33, 64, 128])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_ae_epilogue_matches_plain(cuda_device, dtype, c, act, nres, layout):
    """The kernel against the eager chain on the same conv output, bit for
    bit: a packed channels-last y or a transposed conv's TF-SAME crop view
    (read through its strides), 0-2 residuals, NaN, +-inf and -0.0 among y,
    the residuals and a channel whose BatchNorm maps -0.0 to -0.0."""
    from imgcomp_cvpr_tpu_torch.ops.kernels import ae_epilogue as epi
    g = torch.Generator().manual_seed(1000 * c + 10 * nres + act)
    n, h, w = 2, 5, 7
    cl = torch.channels_last
    full = (torch.randn(n, c, h + 3, w + 4, generator=g) * 3).to(cuda_device, dtype)
    full = full.contiguous(memory_format=cl)
    y = full[:, :, 1:1 + h, 2:2 + w] if layout == 'crop' else \
        full[:, :, :h, :w].contiguous(memory_format=cl)
    k = c // 2
    specials = [((0, c - 1, 1, 2), float('nan')), ((1, 0, 0, 0), float('inf')),
                ((1, k, h - 1, w - 1), float('-inf')), ((0, k, 2, 3), -0.0)]
    for idx, v in specials:
        y[idx] = v
    mean, scale, bias = (torch.randn(c, generator=g) for _ in range(3))
    var = torch.rand(c, generator=g) * 2
    mean[k], bias[k] = 0.0, -0.0
    mean, bias = mean.to(cuda_device), bias.to(cuda_device)
    mul = torch.rsqrt(var.to(cuda_device) + 1e-5) * scale.abs().to(cuda_device)
    rs = [torch.randn(n, c, h, w, generator=g).to(cuda_device, dtype).contiguous(memory_format=cl)
          for _ in range(nres)]
    for i, r in enumerate(rs):
        r[1, c - 1 - i, 3, 4] = float('nan')
        r[0, i, 0, 1] = float('-inf')
    before = build.LAUNCHES['ae_epilogue']
    out = epi.epilogue(y, mean, mul, bias, act, rs)
    assert build.LAUNCHES['ae_epilogue'] == before + 1
    assert out.is_contiguous(memory_format=cl) and out.dtype == dtype
    plain = epi.epilogue_plain(y, mean, mul, bias, act, rs)
    torch.cuda.synchronize()
    _same_bits(out, plain)
    assert torch.isnan(out[0, c - 1, 1, 2])


def test_ae_epilogue_refuses_autograd_and_bad_operands(cuda_device):
    from imgcomp_cvpr_tpu_torch.ops.kernels import ae_epilogue as epi
    y = torch.randn(1, 8, 3, 3, device=cuda_device).contiguous(memory_format=torch.channels_last)
    ones = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError, match='grad'):
        epi.epilogue(y.requires_grad_(), ones, ones, ones, True)
    with pytest.raises(ValueError, match='float32'):
        epi.epilogue(y.detach().half(), ones, ones, ones, True)
    with pytest.raises(ValueError, match='residual'):
        epi.epilogue(y.detach(), ones, ones, ones, True, [y.detach().bfloat16()])


@pytest.mark.parametrize('dtype,batch', [(torch.bfloat16, 16), (torch.bfloat16, 1),
                                         (torch.float32, 1)])
def test_ae_fused_eval_against_eager(cuda_device, monkeypatch, dtype, batch):
    """The trained AE on natkodak24 images (512x768): the fused eval path
    (channels-last, implicit pads, one epilogue launch a conv, 35 an encode
    and 35 a decode) equals the same convolutions followed by the plain
    chain bit for bit, and stays within the benchmark judge's limits of the
    eager towers as they were (NCHW, padded copies, separate ops): symbols
    differ on at most 0.5% of an image, and the decode of the same symbols
    within 0.35 RMS pixel levels an image."""
    import glob
    import os
    from PIL import Image
    from imgcomp_cvpr_tpu_torch import weights as weights_lib
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ael
    from imgcomp_cvpr_tpu_torch.ops.kernels import ae_epilogue as epi
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ae_cfg, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc_cfg, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    ae = ael.CVPRAutoencoder(ae_cfg, device=cuda_device, dtype=dtype)
    pc = pcl.ProbClassifier(pc_cfg, ae_cfg.num_centers, device=cuda_device)
    weights_lib.load_trained(os.path.join(root, 'assets', 'demo_trained_low_9000.npz'),
                             ae, pc, device=cuda_device)
    paths = sorted(glob.glob(os.path.join(root, 'work_rd', 'natkodak24', '*.png')))[:batch]
    x = torch.from_numpy(np.stack([np.asarray(Image.open(p).convert('RGB')) for p in paths]))
    x = x.to(cuda_device, torch.float32)
    before = build.LAUNCHES['ae_epilogue']
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        enc = ae.encode(x)
        out = ae.decode(enc.qhard)
        assert build.LAUNCHES['ae_epilogue'] == before + 70
        monkeypatch.setattr(epi, 'epilogue', epi.epilogue_plain)
        enc_p = ae.encode(x)
        out_p = ae.decode(enc.qhard)
    torch.cuda.synchronize()
    assert build.LAUNCHES['ae_epilogue'] == before + 70
    _same_bits(enc.z, enc_p.z)
    assert torch.equal(enc.symbols, enc_p.symbols)
    _same_bits(out, out_p)
    with torch.no_grad():
        z_eager = ae_eager.encode_z(ae.encoder, x, False)
        out_eager = ae_eager.decode(ae.decoder, enc.qhard, False)
    sym_eager = quantizer_lib.quantize(z_eager, ae.encoder.centers.detach(), sigma=1.0).symbols
    mism = (sym_eager != enc.symbols).float().mean((1, 2, 3))
    rms = torch.sqrt(torch.mean((out - out_eager) ** 2, (1, 2, 3)))
    print(f'{dtype} B={batch}: symbol mismatch max {float(mism.max()):.6f}, '
          f'decode rms max {float(rms.max()):.6f}')
    assert float(mism.max()) <= 0.005 and float(rms.max()) <= 0.35
