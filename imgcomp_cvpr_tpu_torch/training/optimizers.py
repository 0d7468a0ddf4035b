"""Learning-rate schedules and the three-group optimizer (port of
imgcomp_cvpr_tpu/training/optimizers.py).

Three groups, each with its own update rule and schedule like the
reference's optax.multi_transform: ``ae`` (every AE parameter but the
centers, ae_config), ``centers`` (ae_config, at lr_ae * lr_centers_factor
when that is set) and ``pc`` (the context model, pc_config). Each group is
one torch optimizer (ADAM -> Adam, whose default form m_hat / (sqrt(v_hat)
+ 1e-8) without weight decay is optax.adam's; SGD; MOMENTUM -> SGD with
Nesterov momentum) with one LambdaLR. A group whose training is switched
off (train_autoencoder / train_probclass False) gets no optimizer: its
parameters stay, while BatchNorm statistics still move.

Schedules (ref: training_helpers.py:22-35): FIXED, or DECAY,
lr_initial * rate ** floor(step / (itr_per_epoch * interval)) (no floor
when lr_schedule_decay_staircase is False), the step counted from 0 at
the first update.

For a step captured in a CUDA graph (training/trainer.py),
``make_capturable`` turns every group into Adam's capturable form: the step
counter on the device and the rate a 0-d float32 tensor there, which the
LambdaLR fills in place (``schedule``, on the host after each replay), so a
replayed update reads the rate of its own step. Capturable Adam takes the
bias corrections on the device in float32 and divides in another order
than the host form, so its updates round differently from the CPU's.
``state_dict`` saves every group in the host form (a float rate, the
counter on the CPU, ``capturable`` False), so checkpoints do not depend on
the path that wrote them; ``load_state_dict`` replaces the state's tensors
and counts a new ``version``, after which a captured step is stale.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch
from torch.optim.lr_scheduler import LambdaLR


def num_itr_per_epoch(num_images: int, batch_size: int, num_crops_per_img: int) -> int:
    unique_per_batch = max(batch_size // max(num_crops_per_img, 1), 1)
    return max(num_images // unique_per_batch, 1)


def getattr_or(config, key: str, default: Any) -> Any:
    try:
        return getattr(config, key)
    except AttributeError:
        return default


def make_schedule(config, itr_per_epoch: int) -> Callable[[int], float]:
    """step -> learning rate."""
    if config.lr_schedule == 'FIXED':
        return lambda step: config.lr_initial
    if config.lr_schedule == 'DECAY':
        transition = itr_per_epoch * config.lr_schedule_decay_interval
        staircase = bool(getattr_or(config, 'lr_schedule_decay_staircase', True))

        def schedule(step: int) -> float:
            e = step / transition
            return config.lr_initial * config.lr_schedule_decay_rate ** (
                math.floor(e) if staircase else e)
        return schedule
    raise ValueError(f'Invalid lr_schedule {config.lr_schedule}')


def make_single_optimizer(config, params: List[torch.nn.Parameter]
                          ) -> torch.optim.Optimizer:
    """The update rule of ``config.optimizer`` at lr 1: the group's LambdaLR
    supplies the whole learning rate."""
    opt = config.optimizer
    if opt == 'ADAM':
        return torch.optim.Adam(params, lr=1.0)
    if opt == 'SGD':
        return torch.optim.SGD(params, lr=1.0)
    if opt == 'MOMENTUM':
        return torch.optim.SGD(params, lr=1.0, momentum=config.optimizer_momentum,
                               nesterov=True)
    raise ValueError(f'Invalid optimizer {opt}')


class GroupedOptimizer:
    """The groups' optimizers and schedulers, stepped together."""

    def __init__(self, optimizers: Dict[str, torch.optim.Optimizer],
                 schedulers: Dict[str, LambdaLR]):
        self.optimizers = optimizers
        self.schedulers = schedulers
        self.version = 0        # load_state_dict counts one

    def zero_grad(self) -> None:
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Every group's update, then every group's next rate (no group's
        update reads another's rate)."""
        self.update()
        self.schedule()

    def update(self) -> None:
        """The groups' updates, without their schedules."""
        for opt in self.optimizers.values():
            opt.step()

    def schedule(self) -> None:
        """Each group's rate for the next update (a capturable group's rate
        tensor, which a captured update reads, is filled in place)."""
        for sched in self.schedulers.values():
            sched.step()

    @property
    def graphable(self) -> bool:
        """Whether every group can run in a CUDA graph (Adam's capturable form)."""
        return all(type(o) is torch.optim.Adam for o in self.optimizers.values())

    def make_capturable(self) -> None:
        """Every group in Adam's capturable form, on its parameters' device
        (idempotent; see the module docstring)."""
        for opt in self.optimizers.values():
            dev = opt.param_groups[0]['params'][0].device
            for group in opt.param_groups:
                group['capturable'] = True
                lr = group['lr']
                if not (torch.is_tensor(lr) and lr.device == dev):
                    group['lr'] = torch.full((), float(lr), dtype=torch.float32, device=dev)
            for st in opt.state.values():
                if 'step' in st and st['step'].device != dev:
                    st['step'] = st['step'].to(device=dev, dtype=torch.float32)

    def learning_rates(self) -> Dict[str, float]:
        """The rate each group's next update will use."""
        return {name: float(opt.param_groups[0]['lr'])
                for name, opt in self.optimizers.items()}

    def state_dict(self) -> Dict[str, Dict]:
        return {'optimizer': {k: _host_form(o.state_dict()) for k, o in self.optimizers.items()},
                'schedulers': {k: s.state_dict() for k, s in self.schedulers.items()}}

    def load_state_dict(self, state: Dict[str, Dict]) -> None:
        for k, o in self.optimizers.items():
            o.load_state_dict(state['optimizer'][k])
        for k, s in self.schedulers.items():
            s.load_state_dict(state['schedulers'][k])
        self.version += 1


def _host_form(sd: Dict) -> Dict:
    """An optimizer's state dict as the host form saves it: float rates,
    ``capturable`` False, step counters on the CPU (the groups are the
    dict's own; the per-parameter states are copied, not changed)."""
    for group in sd['param_groups']:
        if torch.is_tensor(group['lr']):
            group['lr'] = float(group['lr'])
        if group.get('capturable'):
            group['capturable'] = False
    sd['state'] = {i: {k: v.cpu() if k == 'step' else v for k, v in st.items()}
                   for i, st in sd['state'].items()}
    return sd


def make_optimizer(ae, pc, ae_config, pc_config, itr_per_epoch: int) -> GroupedOptimizer:
    """Optimizer over the parameters of the modules ``ae`` and ``pc``."""
    centers = ae.encoder.centers
    ae_sched = make_schedule(ae_config, itr_per_epoch)
    centers_factor = getattr_or(ae_config, 'lr_centers_factor', None) or 1.0
    groups = {}
    if getattr_or(ae_config, 'train_autoencoder', True):
        groups['ae'] = (ae_config, [p for p in ae.parameters() if p is not centers],
                        ae_sched)
        groups['centers'] = (ae_config, [centers],
                             lambda step: ae_sched(step) * centers_factor)
    if getattr_or(ae_config, 'train_probclass', True):
        groups['pc'] = (pc_config, list(pc.parameters()),
                        make_schedule(pc_config, itr_per_epoch))
    optimizers, schedulers = {}, {}
    for name, (config, params, schedule) in groups.items():
        optimizers[name] = make_single_optimizer(config, params)
        schedulers[name] = LambdaLR(optimizers[name], schedule)
    return GroupedOptimizer(optimizers, schedulers)
