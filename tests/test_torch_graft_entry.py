"""Port vs JAX package: the top-level entry points (graft_entry_torch.py against
__graft_entry__.py) on the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import graft_entry_torch as tentry
from imgcomp_cvpr_tpu_torch import weights as tweights


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread here and in the spawned ranks (they read
    OMP_NUM_THREADS when they import torch)."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_configs_are_the_jax_entry_configs():
    for tiny in (False, True):
        for mine, ref in zip(tentry._configs(tiny), jentry._configs(tiny)):
            assert sorted(mine.keys()) == sorted(ref.keys())
            for key in ref.keys():
                assert getattr(mine, key) == getattr(ref, key), key


def test_entry_matches_jax_entry():
    """entry()'s fn on the JAX entry()'s example args, with the JAX weights
    carried across by weights.ae_state_dict / pc_state_dict, against the
    JAX fn under jit: x_out within the AE decode tolerance of
    test_torch_models.py (1e-2 on the 0-255 scale; 0.0031 measured), bpp
    within the context model's (rtol 1e-5)."""
    jfn, (ae_vars, pc_vars, x) = jentry.entry()
    with jax.default_matmul_precision('highest'):
        jout, jbpp = jax.jit(jfn)(ae_vars, pc_vars, x)
    fn, (ae, pc, x_t) = tentry.entry(device='cpu')
    np.testing.assert_array_equal(x_t.numpy(), np.array(x))    # the same seeded image
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    ae.load_state_dict(tweights.ae_state_dict(host(ae_vars['params']),
                                              host(ae_vars['batch_stats']), ae), strict=True)
    pc.load_state_dict(tweights.pc_state_dict(host(pc_vars['params'])), strict=True)
    out, bpp = fn(ae, pc, torch.from_numpy(np.array(x)))
    assert tuple(out.shape) == (1, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-2)
    np.testing.assert_allclose(float(bpp), float(jbpp), rtol=1e-5)


def test_entry_weights_are_seeded():
    """Two entry() calls build the same weights (explicit torch.Generators)
    and fn gives the same finite outputs; without a card the default device
    raises instead of running on the CPU."""
    fn, (ae1, pc1, x1) = tentry.entry(device='cpu')
    _, (ae2, pc2, x2) = tentry.entry(device='cpu')
    for a, b in ((ae1, ae2), (pc1, pc2)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    out1, bpp1 = fn(ae1, pc1, x1)
    out2, bpp2 = fn(ae2, pc2, x2)
    assert torch.equal(out1, out2) and float(bpp1) == float(bpp2)
    assert torch.isfinite(out1).all() and np.isfinite(float(bpp1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            tentry.entry()


def test_dryrun_multichip_two_gloo_ranks(capsys):
    """Two gloo ranks on the CPU (no card here): the data-parallel train
    step, evaluation over two devices and the codec round trip of 3
    latents over two devices, CRC-verified."""
    tentry.dryrun_multichip(2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith('dryrun_multichip(2): ok, loss=')
    assert 'step=1' in line and 'batch 3 over 2 devices' in line
