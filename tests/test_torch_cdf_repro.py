"""The port's CPU CDF (cuda_kernel.logits_to_cdf) as a function of each
element alone, and the K=5 CPU codec's tables the same in every process.

The fault this guards: torch.exp on the CPU hands each OpenMP thread of
ATen's parallel_for its share of the tensor, and each calls MKL's vmsExp.
MKL picks its code path at its first call in a process; when two threads
make that first call at once, one of them can compute its share on MKL's
AVX2 path at EP accuracy (relative error up to 1.4e-4) instead of the
AVX-512 path at HA accuracy. In a few fresh processes in a hundred, the
encode's one large CDF call (the first exp of the process) then disagreed
with the decode's small per-step calls, and a K=5 stream failed its own
CRC. The race cannot be forced; these tests force what it produced (MKL's
EP path) and hold the repaired function to the properties that rule it out.
"""

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu_torch.coding import codec as tcodec
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
from imgcomp_cvpr_tpu_torch.coding import rans as trans
from imgcomp_cvpr_tpu_torch.tools import ab_streams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, L, BATCH = (4, 6, 7), 6, 2       # ab_streams' K=5 workload of the fault

VML_EP = 0x3      # MKL's vmsExp mode flag for EP accuracy (mkl_vml_defines.h)


@pytest.fixture
def threads():
    """Restores torch's intra-op thread count after a test sets it."""
    n = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(n)


def _logits(rows, seed=0):
    """Seeded (rows, L) float32 logits spread like the context model's."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(rows, L) * 4).astype(np.float32))


def _cdf_bytes(fq, cl):
    return fq.numpy().tobytes() + cl.numpy().tobytes()


_EP_SCRIPT = r'''
import ctypes, os, sys
import numpy as np, torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), 'lib', 'libtorch_cpu.so'))
x = np.load(sys.argv[1])
y = np.empty_like(x)
lib.VMSEXP_(ctypes.byref(ctypes.c_int(x.size)), x.ctypes.data_as(ctypes.c_void_p),
            y.ctypes.data_as(ctypes.c_void_p), ctypes.byref(ctypes.c_longlong(int(sys.argv[3]))))
np.save(sys.argv[2], y)
'''

_CDF_SCRIPT = r'''
import sys
import numpy as np, torch
from imgcomp_cvpr_tpu_torch.coding import cuda_kernel as ck
fq, cl = ck.logits_to_cdf(torch.from_numpy(np.load(sys.argv[1])))
sys.stdout.buffer.write(fq.numpy().tobytes() + cl.numpy().tobytes())
'''


def test_mkl_ep_path_moves_the_tables_and_the_cpu_cdf_never_takes_it(tmp_path, monkeypatch):
    """The bits of the fault: MKL's AVX2 path at EP accuracy (forced in a
    subprocess through MKL_ENABLE_INSTRUCTIONS and the mode argument that
    ATen passes as HA) is within 1.5e-4 of torch.exp's HA value but moves
    CDF entries, so a thread that lands on it changes the tables. The
    repaired CPU CDF calls no torch.exp (no vmsExp) at all, and gives the
    same bits in that subprocess's MKL setting as here."""
    try:
        ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), 'lib',
                                 'libtorch_cpu.so')).VMSEXP_
    except (OSError, AttributeError):
        pytest.skip('this torch has no MKL vmsExp: the fault\'s path does not exist')
    lg = _logits(20000)
    d = (lg - lg.max(-1, keepdim=True).values).contiguous()
    np.save(tmp_path / 'd.npy', d.numpy())
    env = dict(os.environ, MKL_ENABLE_INSTRUCTIONS='AVX2', OMP_NUM_THREADS='1')
    subprocess.run([sys.executable, '-c', _EP_SCRIPT, str(tmp_path / 'd.npy'),
                    str(tmp_path / 'ep.npy'), str(VML_EP)], env=env, check=True, timeout=120)
    ep = torch.from_numpy(np.load(tmp_path / 'ep.npy'))
    ha = torch.exp(d)
    rel = ((ep.double() - ha.double()) / ha.double()).abs()
    assert (ep != ha).float().mean() > 0.5 and 1e-6 < rel.max() < 1.5e-4

    def cdf_from(e):
        s = e[..., 0]
        for i in range(1, L):
            s = s + e[..., i]
        return trans.quantize_cdf(e / s[..., None])

    moved = (cdf_from(ep)[0] != cdf_from(ha)[0]).any(-1)
    assert moved.sum() > 0.01 * moved.numel()

    fq, cl = ck.logits_to_cdf(lg)
    assert torch.equal(fq, cdf_from(ck.exp_host(d))[0])
    with monkeypatch.context() as mp:
        def no_cpu_exp(x, *a, **k):
            raise AssertionError('torch.exp on the CPU reaches MKL\'s vmsExp')
        mp.setattr(torch, 'exp', no_cpu_exp)
        fq2, cl2 = ck.logits_to_cdf(lg)
    assert torch.equal(fq, fq2) and torch.equal(cl, cl2)
    np.save(tmp_path / 'lg.npy', lg.numpy())
    out = subprocess.run([sys.executable, '-c', _CDF_SCRIPT, str(tmp_path / 'lg.npy')],
                         env=dict(env, PYTHONPATH=ROOT), cwd=ROOT, capture_output=True,
                         check=True, timeout=120)
    assert out.stdout == _cdf_bytes(fq, cl)


@pytest.mark.parametrize('n_threads', [1, 4])
def test_logits_to_cdf_same_bits_for_any_split(threads, n_threads):
    """One tensor, and the same rows in pieces of 1, 7 and 1,000 (and
    shifted by an odd row, so no piece starts where the whole did), give the
    same (freq, cdf) bits under 1 and 4 torch threads."""
    threads(n_threads)
    lg = _logits(12000, seed=n_threads)
    whole = _cdf_bytes(*ck.logits_to_cdf(lg))
    for piece, rows in ((1, 1500), (7, 12000), (1000, 12000)):
        for start in (0, 3):
            parts = [ck.logits_to_cdf(lg[a:a + piece].clone())
                     for a in range(start, rows, piece)]
            fq = torch.cat([p[0] for p in parts])
            cl = torch.cat([p[1] for p in parts])
            ref = ck.logits_to_cdf(lg[start:rows])
            assert torch.equal(fq, ref[0]) and torch.equal(cl, ref[1]), (piece, start)
    assert whole == _cdf_bytes(*ck.logits_to_cdf(lg))


_TABLES_SCRIPT = r'''
import hashlib, sys
import numpy as np, torch
from imgcomp_cvpr_tpu_torch.coding import codec
from imgcomp_cvpr_tpu_torch.tools import ab_streams
shape = (4, 6, 7)
pc, cfg, centers, rng, _ = ab_streams._build(shape, 6, 5, 0, 'cpu')
syms = torch.from_numpy(rng.randint(0, 6, size=(2,) + shape).astype(np.int32))
coder = codec.LatentCodec(pc, cfg, device='cpu', impl='cuda_planar').coder(6)
_, fold = coder._prepare(shape, torch.from_numpy(centers))
f, s = coder.encode_tables(syms, fold)
print(hashlib.sha256(f.numpy().tobytes() + s.numpy().tobytes()).hexdigest())
'''


def _k5_workload():
    pc, cfg, centers, rng, _ = ab_streams._build(SHAPE, L, 5, 0, 'cpu')
    syms = torch.from_numpy(rng.randint(0, L, size=(BATCH,) + SHAPE).astype(np.int32))
    return pc, cfg, torch.from_numpy(centers), syms


def test_k5_encode_tables_one_digest_in_fresh_processes():
    """Fresh processes with two OpenMP threads each (the setting of the
    fault) compute the K=5 layer-parallel plain encode tables of ab_streams'
    (4, 6, 7) B=2 workload: one digest, the scan oracle's (its per-step CDF
    calls are small, one thread each)."""
    env = dict(os.environ, OMP_NUM_THREADS='2', PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, '-c', _TABLES_SCRIPT], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, text=True) for _ in range(4)]
    pc, cfg, centers, syms = _k5_workload()
    coder = tcodec.LatentCodec(pc, cfg, device='cpu', impl='cuda_planar').coder(6)
    _, fold = coder._prepare(SHAPE, centers)
    f, s = coder.encode_tables_scan(syms, fold)
    oracle = hashlib.sha256(f.numpy().tobytes() + s.numpy().tobytes()).hexdigest()
    digests = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert digests == {oracle}


@pytest.mark.parametrize('K', [3, 5])
def test_encode_and_decode_cdfs_bit_equal(monkeypatch, threads, K):
    """On every cell of ab_streams' (4, 6, 7) B=2 workload at K=3 and K=5,
    with two threads, the CDF the decode computes (one wavefront step at a
    time) is bit for bit the CDF the layer-parallel encode computed from
    the same logits in its one large call; and the round trip is exact."""
    threads(2)
    pc, cfg, centers, rng, _ = ab_streams._build(SHAPE, L, K, 0, 'cpu')
    syms = rng.randint(0, L, size=(BATCH,) + SHAPE).astype(np.int8)
    lc = tcodec.LatentCodec(pc, cfg, device='cpu', impl='cuda' if K == 3 else 'cuda_planar')
    seen = {}
    orig = ck.logits_to_cdf

    def recording(logits):
        fq, cl = orig(logits)
        rows = logits.reshape(-1, L).numpy()
        tab = np.concatenate([fq.reshape(-1, L).numpy(), cl.reshape(-1, L).numpy()], 1)
        for r, t in zip(rows, tab):
            seen[side].setdefault(r.tobytes(), t.tobytes())
        return fq, cl

    monkeypatch.setattr(ck, 'logits_to_cdf', recording)
    side = 'encode'
    seen[side] = {}
    res = lc.encode_batch(syms, centers)
    side = 'decode'
    seen[side] = {}
    dec = lc.decode_batch([r.bitstream for r in res], centers, verify=True)
    assert np.array_equal(np.asarray(dec), syms.astype(np.int32))
    # Every row the encode saw is a computed cell's (its dead lanes repeat
    # the last cell); the decode also sees, on its dead lanes, rows of cells
    # not computed yet, whose CDFs it does not use.
    enc, dec_rows = seen['encode'], seen['decode']
    assert len(enc) >= BATCH * np.prod(SHAPE) // 2
    assert enc.keys() <= dec_rows.keys()
    assert all(dec_rows[k] == v for k, v in enc.items())
