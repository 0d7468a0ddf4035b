"""Map the JAX package's parameter trees (as numpy) onto the port's modules.

``load_npz`` reads a flax tree saved as one npz entry per leaf, keys split
on '/' (the layout of assets/demo_trained_low_9000.npz, read the same way
as bench.py's load_trained). ``ae_state_dict`` / ``pc_state_dict`` turn
the ``params['ae']`` / ``batch_stats`` and ``params['pc']`` subtrees into
state dicts of models.autoencoder.CVPRAutoencoder and
models.probclass.ProbClassifier:

- 2D conv kernels HWIO -> OIHW (F.conv2d); transposed convs HWIO ->
  IOHW (F.conv_transpose2d: (kh, kw, I, O) -> (I, O, kh, kw));
- masked 3D kernels (kd, k, k, cin, cout) -> (cout, cin, kd, k, k);
- BatchNorm scale / bias / mean / var; the quantizer centers; the context
  model's learned pad variable.

``ae_trees`` / ``pc_tree`` are the inverses: they lay named tensors of the
port (a state dict, or parameter gradients by parameter name) out as flax
trees of numpy arrays, so that gradients can be held against ``jax.grad``'s
leaf by leaf and a checkpoint of the port can be mapped back.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import resolve_device


def load_npz(path: str) -> Dict:
    """npz of '/'-joined flax keys -> nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split('/')
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order='C', copy=True))


def ae_state_dict(params: Dict, batch_stats: Dict, model) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (a CVPRAutoencoder) from the flax AE
    ``params`` (encoder/..., decoder/...) and ``batch_stats``. Every leaf of
    both trees is used exactly once; a leaf the model has no slot for raises."""
    sd = {}
    transposed = {name for name, m in model.named_modules()
                  if getattr(m, 'transpose', False)}
    for path, a in _flatten(params).items():
        if path[-1] == 'centers':
            sd['.'.join(path)] = _t(a)
        elif path[-1] == 'w':
            mod = '.'.join(path[:-1])
            perm = (2, 3, 0, 1) if mod in transposed else (3, 2, 0, 1)
            sd[mod + '.weight'] = _t(a.transpose(perm))
        elif path[-2] == 'BatchNorm_0' and path[-1] in ('scale', 'bias'):
            sd['.'.join(path[:-2]) + '.bn_' + path[-1]] = _t(a)
        else:
            raise KeyError(f'unmapped AE param {"/".join(path)}')
    for path, a in _flatten(batch_stats).items():
        if path[-2] != 'BatchNorm_0' or path[-1] not in ('mean', 'var'):
            raise KeyError(f'unmapped AE batch stat {"/".join(path)}')
        sd['.'.join(path[:-2]) + '.bn_' + path[-1]] = _t(a)
    return sd


def pc_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """State dict for a ProbClassifier from the flax PC ``params`` (the
    subtree under params['pc'], optionally still wrapped in 'params')."""
    if set(params) == {'params'}:
        params = params['params']
    sd = {}
    for path, a in _flatten(params).items():
        mod = 'net.' + '.'.join(path[:-1])
        if path == ('pad_var',):
            sd['net.pad_var'] = _t(a)
        elif path[-1] == 'w':
            sd[mod + '.weight'] = _t(a.transpose(4, 3, 0, 1, 2))
        elif path[-1] == 'b':
            sd[mod + '.bias'] = _t(a)
        else:
            raise KeyError(f'unmapped PC param {"/".join(path)}')
    return sd


def _set(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def ae_trees(named: Dict[str, torch.Tensor], model) -> Tuple[Dict, Dict]:
    """Inverse of ``ae_state_dict``: tensors keyed by the names of
    ``model``'s state dict (any subset: a state dict, or gradients by
    parameter name) -> flax (params, batch_stats) trees of numpy arrays."""
    transposed = {name for name, m in model.named_modules()
                  if getattr(m, 'transpose', False)}
    params, stats = {}, {}
    for name, t in named.items():
        a = t.detach().cpu().numpy()
        *mod, leaf = name.split('.')
        if leaf == 'centers':
            _set(params, mod + ['centers'], a)
        elif leaf == 'weight':
            # inverse of OIHW <- HWIO (3, 2, 0, 1) and of IOHW <- HWIO (2, 3, 0, 1)
            _set(params, mod + ['w'], a.transpose((2, 3, 0, 1) if '.'.join(mod) in transposed
                                                  else (2, 3, 1, 0)))
        elif leaf in ('bn_scale', 'bn_bias'):
            _set(params, mod + ['BatchNorm_0', leaf[3:]], a)
        elif leaf in ('bn_mean', 'bn_var'):
            _set(stats, mod + ['BatchNorm_0', leaf[3:]], a)
        else:
            raise KeyError(f'unmapped AE tensor {name}')
    return params, stats


def pc_tree(named: Dict[str, torch.Tensor]) -> Dict:
    """Inverse of ``pc_state_dict``: tensors keyed by the names of a
    ProbClassifier's state dict -> the flax PC params tree of numpy arrays."""
    params = {}
    for name, t in named.items():
        a = t.detach().cpu().numpy()
        net, *mod, leaf = name.split('.')
        if net != 'net':
            raise KeyError(f'unmapped PC tensor {name}')
        if leaf == 'pad_var' and not mod:
            params['pad_var'] = a
        elif leaf == 'weight':
            _set(params, mod + ['w'], a.transpose(2, 3, 4, 1, 0))
        elif leaf == 'bias':
            _set(params, mod + ['b'], a)
        else:
            raise KeyError(f'unmapped PC tensor {name}')
    return params


def load_trained(path: str, ae, pc, device='cuda'):
    """Load a trained npz (params/{ae,pc}, batch_stats) into ``ae`` and
    ``pc`` in place, strictly (a missing or extra tensor raises), and leave
    both on ``device`` (raises for 'cuda' with no card).
    Returns (ae, pc)."""
    dev = resolve_device(device)
    tree = load_npz(path)
    ae.load_state_dict(ae_state_dict(tree['params']['ae'], tree['batch_stats'], ae),
                       strict=True)
    pc.load_state_dict(pc_state_dict(tree['params']['pc']), strict=True)
    return ae.to(dev), pc.to(dev)
