"""Nothing under perfbench/ imports JAX or the JAX package (top-level names
compared whole: imgcomp_cvpr_tpu_torch is the port), and the reference
imports nothing of the program."""

import ast
import os

import pytest

from perfbench import harness


def _modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=''):
    for root, _, files in os.walk(os.path.join(harness.HERE, sub)):
        yield from (os.path.join(root, f) for f in files if f.endswith('.py'))


@pytest.mark.parametrize('path', sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_side(path):
    tops = {m.split('.', 1)[0] for m in _modules(path)}
    assert not tops & set(harness.FORBIDDEN_MODULES), tops


@pytest.mark.parametrize('path', sorted(_sources('reference')),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split('.', 1)[0] for m in _modules(path)}
    assert tops <= {'__future__', 'contextlib', 'math', 'typing', 'numpy', 'torch'}, tops


def test_forbidden_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, 'imgcomp_cvpr_tpu_torch_fake', types.ModuleType('x'))
    assert 'imgcomp_cvpr_tpu' not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'imgcomp_cvpr_tpu.fake', types.ModuleType('y'))
    assert 'imgcomp_cvpr_tpu' in harness.forbidden_loaded()
