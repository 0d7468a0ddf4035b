"""``ckpt_mapper npz``: a checkpoint of ``train_torch.py`` (a tiny trainer's
state after one step, optimizer moments included) exported to the flat
'params/...' / 'batch_stats/...' npz layout of the trained assets, then read
back by the port (``weights.load_trained``) and by the benchmark's
reference (``perfbench/reference/cvpr.load_npz``): the same tensors on both
sides, every leaf mapped, no optimizer state in the file."""

import numpy as np
import pytest
import torch

from imgcomp_cvpr_tpu_torch import weights as weights_lib
from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
from imgcomp_cvpr_tpu_torch.tools import ckpt_mapper
from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
from imgcomp_cvpr_tpu_torch.utils import config as config_lib
from perfbench import models as pb_models
from perfbench.reference import cvpr as ref

TINY_AE = """use {root}/ae/cvpr/low_demo
arch_param_B = 1
num_chan_bn = 4
batch_size = 2
crop_size = (32, 32)
distortion_to_minimize = 'mse'
"""
TINY_PC = """use {root}/pc/cvpr/res_shallow_demo
arch_param__k = 4
"""


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small tensors gain nothing from intra-op threads, and several test
    workers side by side oversubscribe the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """(ae spec path, checkpoint path, the state after one train step)."""
    d = tmp_path_factory.mktemp('ckpt_npz')
    root = config_lib.default_config_root()
    (d / 'tiny_ae').write_text(TINY_AE.format(root=root))
    (d / 'tiny_pc').write_text(TINY_PC.format(root=root))
    ae_config, _ = config_lib.parse_spec(str(d / 'tiny_ae'), 'ae')
    pc_config, _ = config_lib.parse_spec(str(d / 'tiny_pc'), 'pc')
    trainer = trainer_lib.Trainer(ae_config, pc_config, num_train_images=4, device='cpu')
    state = trainer.init_state(3)
    batch = torch.from_numpy((np.random.RandomState(0).rand(2, 32, 32, 3) * 255)
                             .astype(np.uint8))
    state, _ = trainer.train_step(state, batch)
    ckpt = checkpoint_lib.Saver(str(d / 'ckpts')).save(state.state_dict(), 1)
    return str(d / 'tiny_ae'), ckpt, state, (ae_config, pc_config)


def _fresh(configs):
    ae_config, pc_config = configs
    return (ae_lib.CVPRAutoencoder(ae_config, device='cpu'),
            pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device='cpu'))


def _half(name, t):
    """What the half export keeps of a tensor: AE convolution kernels
    rounded to float16."""
    return t.half().float() if name.endswith('.weight') else t


@pytest.mark.parametrize('half', [False, True])
def test_export_reads_back_in_port_and_reference(tmp_path, trained, half):
    spec, ckpt, state, configs = trained
    moments = checkpoint_lib.flatten(checkpoint_lib.restore_tree(ckpt)['opt_state'])
    assert any(isinstance(v, torch.Tensor) and v.numel() > 1 for v in moments.values()), \
        'the checkpoint has optimizer moments to leave out'
    out = str(tmp_path / 'w.npz')
    flat = ckpt_mapper.export_npz(ckpt, out, spec, half=half)
    with np.load(out) as z:
        keys = set(z.files)
        dtypes = {k: z[k].dtype for k in z.files}
    assert keys == set(flat)
    assert all(k.startswith(('params/ae/', 'params/pc/', 'batch_stats/')) for k in keys)
    for k, dt in dtypes.items():
        small = half and k.startswith('params/ae/') and k.endswith('/w')
        assert dt == (np.float16 if small else np.float32), k
    want_ae = {n: _half(n, t) if half else t for n, t in state.ae.state_dict().items()}
    want_pc = state.pc.state_dict()
    ae, pc = _fresh(configs)
    weights_lib.load_trained(out, ae, pc, device='cpu')
    for want, got in ((want_ae, ae.state_dict()), (want_pc, pc.state_dict())):
        assert set(want) == set(got)
        for n in want:
            assert torch.equal(want[n], got[n]), n
    ae_p, pc_p = ref.load_npz(out, 'cpu')
    assert len(ae_p) + len(pc_p) == len(keys)
    for want, got in ((want_ae, pb_models.ae_state_dict(ae_p)),
                      (want_pc, pb_models.pc_state_dict(pc_p))):
        assert set(want) == set(got)
        for n in want:
            assert torch.equal(want[n], got[n]), n


def test_unmapped_tensor_raises(tmp_path, trained):
    spec, ckpt, state, _ = trained
    tree = checkpoint_lib.restore_tree(ckpt)
    tree['model']['ae']['encoder.h1.extra'] = torch.zeros(2)
    bad = str(tmp_path / 'ckpt-2')
    torch.save(tree, bad)
    with pytest.raises(KeyError, match='encoder.h1.extra'):
        ckpt_mapper.export_npz(bad, str(tmp_path / 'w.npz'), spec)


def test_npz_command_line(tmp_path, trained, capsys):
    spec, ckpt, _, _ = trained
    out = str(tmp_path / 'cli.npz')
    ckpt_mapper.main(['npz', ckpt, out, '--ae_config', spec, '--half'])
    with np.load(out) as z:
        n = len(z.files)
    assert f'{out}: {n} leaves' in capsys.readouterr().out
