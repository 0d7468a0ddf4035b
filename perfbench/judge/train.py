"""The comparison that decides ``correct`` for the training cell.

Set-up drives the program's training step through its first three steps,
through the window's own call and feed; the plain reference
(reference/cvpr.py: the training forward, loss and Adam) follows the same
three steps from the same initial weights on the same three batches, in
float32 with TF32 off. Compared, each as a share of the reference's:

- ``loss_gap_max``: the worst of the three steps' |program loss -
  reference loss| / |reference loss|;
- ``grad_gap_max``: the first step's gradient as the optimizer got it
  (Adam's first moment after one step over 1 - beta1), by the worst leaf:
  | ||g_program|| - ||g_reference|| | over the larger of the reference
  leaf's norm and the median leaf's;
- ``change_gap_max``: the same of each leaf's change after the three
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone under Adam).

- ``replica_gap_max`` (several cards only): after the three steps, the
  largest absolute difference of any rank's parameters from rank 0's. Every
  rank steps on the same averaged gradient, so the sound reading is 0.

On several cards the program's numbers are rank 0's, and the reference
follows them over the global batch (every rank's slice).

The control is the reference in TF32 (each convolution's operands rounded
to TF32's mantissa) in the program's place.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from perfbench.reference import cvpr as ref

STEPS = 3
NEGLIGIBLE = 1e-3     # a leaf whose reference gradient is under this x the median's


class Run(NamedTuple):
    """What three training steps gave, leaves by reference name."""
    losses: List[float]
    grad1: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


def group_of(key: str) -> str:
    if key == 'encoder.centers':
        return 'centers'
    return 'ae' if key.startswith(('encoder.', 'decoder.')) else 'pc'


def trainable(ae_p: Dict) -> Dict:
    """The AE's parameters (BatchNorm running statistics are not)."""
    return {k: v for k, v in ae_p.items() if not k.endswith(('.mean', '.var'))}


def reference_run(ae0: Dict, pc0: Dict, batches: List[torch.Tensor], hp: Dict,
                  prec: str = 'f32') -> Run:
    """Three steps of the reference from (ae0, pc0) on ``batches``."""
    params = {**{'ae:' + k: v.clone() for k, v in trainable(ae0).items()},
              **{'pc:' + k: v.clone() for k, v in pc0.items()}}
    start = {k: v.clone() for k, v in params.items()}
    opt = ref.Adam({'ae': hp['lr_ae'], 'centers': hp['lr_centers'], 'pc': hp['lr_pc']})
    losses, grad1 = [], None
    with ref.tf32(False):
        for x in batches[:STEPS]:
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            ae_p = {k[3:]: v for k, v in leaves.items() if k.startswith('ae:')}
            pc_p = {k[3:]: v for k, v in leaves.items() if k.startswith('pc:')}
            loss = ref.train_loss(ae_p, pc_p, x, hp, prec)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().clone() for k, g in grads.items()}
            opt.step(params, grads, lambda k: group_of(k[3:]))
    return Run(losses, grad1, {k: params[k] - start[k] for k in params})


def _worst_leaf(prog: Dict, refs: Dict, keys) -> Tuple[float, str]:
    """(the worst leaf's gap, its name)."""
    norms = {k: float(torch.linalg.vector_norm(refs[k].double())) for k in refs}
    med = sorted(norms.values())[len(norms) // 2]
    return max((abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
                / max(norms[k], med), k) for k in keys)


def numbers(program: Run, reference: Run, replica_gap: Optional[float] = None
            ) -> Dict[str, float]:
    loss = max(abs(p - r) / abs(r) for p, r in zip(program.losses, reference.losses))
    gnorm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in reference.grad1.items()}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in gnorm if gnorm[k] >= NEGLIGIBLE * med]
    grad, grad_leaf = _worst_leaf(program.grad1, reference.grad1, reference.grad1)
    change, change_leaf = _worst_leaf(program.change, reference.change, moved)
    out = {'loss_gap_max': loss, 'grad_gap_max': grad, 'change_gap_max': change}
    if replica_gap is not None:
        out['replica_gap_max'] = replica_gap
    out.update({'grad_worst_leaf': grad_leaf, 'change_worst_leaf': change_leaf,
                'change_left_out': [k for k in gnorm if k not in moved],
                'losses': [program.losses, reference.losses]})
    return out
