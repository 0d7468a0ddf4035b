"""Port vs JAX package: the bundled config files (CPU).

The port carries its own verbatim copies of the reference's 12 config
files; each parses in both packages to the same keys and values.
"""

import os

import pytest

from imgcomp_cvpr_tpu.utils import config as jconfig
from imgcomp_cvpr_tpu_torch.utils import config as tconfig

SPECS = [('ae', 'base'), ('ae', 'cvpr/base'), ('ae', 'cvpr/low'), ('ae', 'cvpr/med'),
         ('ae', 'cvpr/hi'), ('ae', 'cvpr/low_demo'), ('ae', 'cvpr/med_demo'),
         ('ae', 'cvpr/hi_demo'), ('pc', 'base'), ('pc', 'cvpr/res_shallow'),
         ('pc', 'cvpr/res_shallow_64'), ('pc', 'cvpr/res_shallow_demo')]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_port_bundles_every_reference_config():
    ref, ours = jconfig.default_config_root(), tconfig.default_config_root()
    assert _files(ours) == _files(ref)
    assert sorted(f'{k}/{s}' for k, s in SPECS) == _files(ref)
    for rel in _files(ref):
        with open(os.path.join(ref, rel), 'rb') as a, open(os.path.join(ours, rel), 'rb') as b:
            assert a.read() == b.read(), rel


@pytest.mark.parametrize('kind,spec', SPECS)
def test_config_parses_like_the_reference(kind, spec):
    ref, ref_rel = jconfig.parse_spec(spec, kind)
    ours, our_rel = tconfig.parse_spec(spec, kind)
    assert our_rel == ref_rel
    assert sorted(ours.keys()) == sorted(ref.keys())
    for key in ref.keys():
        assert getattr(ours, key) == getattr(ref, key), key
