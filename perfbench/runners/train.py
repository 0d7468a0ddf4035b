"""Training steps fed by the program's host input pipeline.

The traffic file gives ``batch``, ``crop`` ([h, w]), ``threads`` (the
pipeline's host threads; one keeps the batches a function of the seed) and
``images`` (the image set: glob, count and sha256). The images are decoded
once at set-up; ``data/pipeline.InputPipeline`` takes seeded random crops
with flips from them; each batch is uploaded from pinned memory without
blocking, as train_loop.py does, and stepped by ``Trainer.train_step``.
The window's feed thus leaves out the per-image decoding of train_loop.py's
file dataset: it measures crop, flip and upload from images in memory.

The weights are drawn on the card from the configuration's ``weight_seed``
(glorot-uniform kernels, BatchNorm scale 1 and bias 0, centers uniform in
their initial range); --seed draws the crops. Set-up runs the first three
steps, which the check compares with the reference, then the window steps
on for --seconds and ends with a synchronize.

On several cards (a ``group``, ranks.py) ``batch`` is still the global
batch, as the configuration's ``batch_size`` is for the program's
train_loop.py: rank 0's pipeline draws it, the program's
``pad_batch_to_multiple`` repeats its last crop up to a multiple of the
ranks, and every rank takes its slice through ``broadcast_batch`` and
``shard_batch`` (30 over four ranks: 32 rows, 8 a rank). Every rank draws
the same initial weights, which the program's ``mesh.replicate`` then
makes rank 0's, and steps them with ``Trainer(mesh=)``. The reference
follows rank 0's three checked steps over the padded global batch. After
them, every rank's parameters are compared with rank 0's
(``replica_gap_max``). Rank 0 decides through the group's gate when the
window ends, so every rank takes the same number of steps; the window ends
with a synchronize and a barrier of all ranks.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from perfbench import harness, models
from perfbench.judge import train as judge_train
from perfbench.reference import cvpr as ref
from perfbench.roofline import counts


def initial_weights(cfg: Dict, seed: int, device) -> models.Weights:
    """AE and context-model weights from ``seed``, drawn on ``device`` (the
    AE's layout taken from the configuration's npz file, its values not)."""
    shapes, _ = ref.load_npz(harness.check_file(cfg['weights']['npz'], cfg['weights']['sha256']),
                             'cpu')
    g = torch.Generator(device=device).manual_seed(seed)
    kernels = [k for k in shapes if k.endswith('.w')]
    sizes = [shapes[k].numel() for k in kernels]
    u = torch.rand(sum(sizes) + shapes['encoder.centers'].numel(), generator=g,
                   device=device) * 2 - 1
    ae, off = {}, 0
    for k, n in zip(kernels, sizes):
        a, b, kh, kw = shapes[k].shape
        ae[k] = (u[off:off + n] * ref.glorot_limit(a * kh * kw, b * kh * kw)).reshape(shapes[k].shape)
        off += n
    lo, hi = cfg['model']['centers_initial_range']
    ae['encoder.centers'] = lo + (hi - lo) * (u[off:] + 1) / 2
    for k, v in shapes.items():
        leaf = k.rsplit('.', 1)[1]
        if leaf in ('scale', 'var'):
            ae[k] = torch.ones(v.shape, device=device)
        elif leaf in ('bias', 'mean'):
            ae[k] = torch.zeros(v.shape, device=device)
    return models.Weights(ae, models.seeded_pc(cfg, seed + 1, device))


def hyper(cfg: Dict) -> Dict:
    """The model's and the training's settings the reference reads."""
    return {**cfg['model'], **cfg['train']}


class Ctx(NamedTuple):
    cfg: Dict
    traffic: Dict
    seed: int
    device: torch.device
    tracer: harness.Tracer
    weights: models.Weights         # the initial weights
    trainer: object                 # imgcomp_cvpr_tpu_torch Trainer
    state: object                   # its TrainState, stepped in place
    pipeline: object                # data/pipeline.InputPipeline, running (None: ranks 1..)
    checked: judge_train.Run        # the program's first three steps
    batches: List[torch.Tensor]     # their inputs (global batches)
    group: Optional[object] = None  # ranks.Group on several cards
    replica_gap: Optional[float] = None     # after the checked steps, on several cards


def _dataset(images: np.ndarray):
    from imgcomp_cvpr_tpu_torch.data import pipeline as pipeline_lib

    class Decoded(pipeline_lib.Dataset):
        """The decoded image set, held in memory."""

        def load(self, idx: int) -> np.ndarray:
            return images[idx]
    return Decoded([f'image://{i}' for i in range(len(images))], 'perfbench')


def pipeline_seed(seed: int, threads: int) -> int:
    """The pipeline's seed from --seed: its workers seed numpy's
    RandomState with seed + worker id, which must stay under 2^32."""
    return int(np.random.SeedSequence(seed).generate_state(1)[0]) % (2 ** 32 - threads)


def upload(batch: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(batch)
    if device.type == 'cuda':
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def fetch(ctx: Ctx) -> Optional[np.ndarray]:
    """The next global batch from the pipeline: rank 0 only (None elsewhere)."""
    return None if ctx.pipeline is None else ctx.pipeline.get_batch()


def put(ctx: Ctx, batch: Optional[np.ndarray]) -> torch.Tensor:
    """Global batch -> this rank's slice on the device: the pinned upload on
    one card; on several, train_loop.py's feed: rank 0's batch padded to a
    multiple of the ranks, broadcast and sharded."""
    if ctx.group is None:
        return upload(batch, ctx.device)
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    mesh = ctx.group.mesh
    shape = (padded(ctx.traffic['batch'], mesh.world_size),) + tuple(ctx.traffic['crop']) + (3,)
    return mesh_lib.shard_batch(mesh_lib.broadcast_batch(
        None if batch is None else pad(ctx, batch), shape, mesh), mesh)


def pad(ctx: Ctx, batch: np.ndarray) -> np.ndarray:
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    return mesh_lib.pad_batch_to_multiple(batch, ctx.group.mesh.world_size)


def padded(batch: int, world: int) -> int:
    """The rows of a global batch once padded for ``world`` ranks."""
    return -(-batch // world) * world


def setup(cfg: Dict, traffic: Dict, seed: int, device, tracer, group=None) -> Ctx:
    from imgcomp_cvpr_tpu_torch.data import pipeline as pipeline_lib
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib
    from imgcomp_cvpr_tpu_torch.training import optimizers as opt_lib
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    ae_config, _ = config_lib.parse_spec(cfg['ae_spec'], 'ae')
    pc_config, _ = config_lib.parse_spec(cfg['pc_spec'], 'pc')
    hp = cfg['train']
    have = {'lr_ae': ae_config.lr_initial, 'lr_pc': pc_config.lr_initial,
            'lr_centers': ae_config.lr_initial * (ae_config.lr_centers_factor or 1.0),
            'beta': ae_config.beta, 'H_target': ae_config.H_target,
            'K_ms_ssim': ae_config.K_ms_ssim,
            'regularization_factor': ae_config.regularization_factor,
            'regularization_factor_centers': ae_config.regularization_factor_centers,
            'distortion': ae_config.distortion_to_minimize,
            'optimizer': [ae_config.optimizer, pc_config.optimizer],
            'pc_regularization_factor': pc_config.regularization_factor}
    for k, v in have.items():
        if hp[k] != v:
            raise RuntimeError(f'config {cfg["name"]}: train {k} is {v!r} in the program, '
                               f'{hp[k]!r} in the file')
    weights = initial_weights(cfg, hp['weight_seed'], device)
    mesh = None if group is None else group.mesh
    trainer = trainer_lib.Trainer(ae_config, pc_config, device=device, mesh=mesh)
    ae = ae_lib.CVPRAutoencoder(ae_config, device=device)
    pc = pc_lib.ProbClassifier(pc_config, ae_config.num_centers, device=device)
    ae.load_state_dict(models.ae_state_dict(weights.ae), strict=True)
    pc.load_state_dict(models.pc_state_dict(weights.pc), strict=True)
    if mesh is not None:        # as Trainer.init_state starts its ranks
        from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
        mesh_lib.replicate([*ae.parameters(), *ae.buffers(), *pc.parameters(),
                            *pc.buffers()], mesh)
    opt = opt_lib.make_optimizer(ae, pc, ae_config, pc_config, trainer.itr_per_epoch)
    state = trainer_lib.TrainState(ae, pc, opt, 0)
    pipe = None
    if group is None or group.lead:
        images = harness.load_images(traffic['images'], 'cpu').numpy()
        pipe = pipeline_lib.InputPipeline(
            _dataset(images), tuple(traffic['crop']), traffic['batch'], shuffle=True, num_preprocess_threads=traffic['threads'], num_crops_per_img=1,
            seed=pipeline_seed(seed, traffic['threads']), prefetch=8).start()
    ctx = Ctx(cfg, traffic, seed, device, tracer, weights, trainer, state, pipe, None, [],
              group)
    ctx = ctx._replace(**first_steps(ctx))
    if group is not None:
        ctx = ctx._replace(replica_gap=replica_gap(ctx))
    return ctx


def _named(ctx: Ctx):
    """(reference name, program parameter) of every trainable leaf."""
    ae_map = {port: 'ae:' + k for k, port in
              zip(judge_train.trainable(ctx.weights.ae),
                  models.ae_state_dict(judge_train.trainable(ctx.weights.ae)))}
    pc_map = {port: 'pc:' + k for k, port in zip(ctx.weights.pc, models.pc_state_dict(ctx.weights.pc))}
    out = [(ae_map[n], p) for n, p in ctx.state.ae.named_parameters()]
    return out + [(pc_map[n], p) for n, p in ctx.state.pc.named_parameters()]


def first_steps(ctx: Ctx) -> Dict:
    """The first three steps through the window's own call and feed, with
    the loss of each, the first gradient as Adam holds it (its first moment
    over 1 - beta1) and each leaf's change after the three."""
    named = _named(ctx)
    start = {k: p.detach().clone() for k, p in named}
    losses, grad1, batches = [], None, []
    for _ in range(judge_train.STEPS):
        host = fetch(ctx)
        x = put(ctx, host)
        if host is not None:    # the rows the program steps on (padded on several cards)
            batches.append(torch.from_numpy(host.copy() if ctx.group is None else pad(ctx, host)))
        _, comps = ctx.trainer.train_step(ctx.state, x)
        losses.append(float(comps['total_loss']))
        if grad1 is None:
            grad1 = {}
            for k, p in named:
                opt = next(o for o in ctx.state.optimizer.optimizers.values()
                           if any(q is p for g in o.param_groups for q in g['params']))
                beta1 = opt.param_groups[0]['betas'][0]
                m = opt.state[p].get('exp_avg')     # none: the step never reached Adam
                grad1[k] = torch.zeros_like(p) if m is None else m.detach() / (1 - beta1)
    change = {k: p.detach() - start[k] for k, p in named}
    return {'checked': judge_train.Run(losses, grad1, change), 'batches': batches}


def replica_gap(ctx: Ctx) -> float:
    """The largest |parameter of any rank - rank 0's| (all parameters,
    flattened): rank 0's are broadcast once and each rank's largest gap is
    all-reduced by its maximum."""
    import torch.distributed as dist
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for _, p in _named(ctx)])
        lead = flat.clone()
        dist.broadcast(lead, src=0)
        gap = (flat - lead).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def window(ctx: Ctx, seconds: float) -> harness.Window:
    if ctx.group is not None:
        return _window_ranks(ctx, seconds)
    sp, dev = ctx.tracer.span, ctx.device
    steps, wait = 0, 0.0
    with sp('window'):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            with sp('fetch'):
                x = upload(ctx.pipeline.get_batch(), dev)
            wait += time.perf_counter() - t
            with sp('train_step'):
                ctx.trainer.train_step(ctx.state, x)
            steps += 1
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    images = steps * ctx.traffic['batch']
    cnt = {'units': steps, 'steps': steps, 'images': images, 'attempted': steps, 'failed': 0}
    return harness.Window(t0, t1, cnt, {'train_img_per_s': images / (t1 - t0)}, [],
                  {'input_wait_ms_host': 1e3 * wait / max(steps, 1)})


def _window_ranks(ctx: Ctx, seconds: float) -> harness.Window:
    """The window on several cards: the ranks start together after a
    barrier; rank 0's clock decides, through the gate, whether the step
    ranks.Gate.LAG steps on is taken; the window ends with a synchronize
    and a barrier, so its time holds every card's last step."""
    sp, dev, group = ctx.tracer.span, ctx.device, ctx.group
    gate = group.gate()
    steps, wait = 0, 0.0
    group.barrier()
    with sp('window'):
        t0 = time.perf_counter()
        while gate.go(steps, lambda: time.perf_counter() - t0 < seconds):
            t = time.perf_counter()
            with sp('fetch'):
                x = put(ctx, fetch(ctx))
            wait += time.perf_counter() - t
            with sp('train_step'):
                ctx.trainer.train_step(ctx.state, x)
            steps += 1
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        group.barrier()
        t1 = time.perf_counter()
    images = steps * ctx.traffic['batch']     # as train_loop.py counts: the padding is not
    cnt = {'units': steps, 'steps': steps, 'images': images, 'attempted': steps, 'failed': 0}
    return harness.Window(t0, t1, cnt, {}, [],
                          {'img_per_s_host': images / (t1 - t0),
                           'input_wait_ms_host': 1e3 * wait / max(steps, 1),
                           'stop_gate_ms_host': 1e3 * gate.seconds / max(steps + 1, 1)})


def work(ctx: Ctx, win: harness.Window) -> Dict:
    """Least device time of one step at the float32 peak: forward and
    backward (the backward twice the forward's operations) of the AE
    convolutions and the context model's masked taps (roofline/counts.py).
    On several cards, one card's share of the padded global batch."""
    m, pk = ctx.cfg['model'], counts.peaks()
    h, w = ctx.traffic['crop']
    world = 1 if ctx.group is None else ctx.group.mesh.world_size
    b = padded(ctx.traffic['batch'], world) // world
    enc, dec = counts.ae_flops(h, w, m['num_chan_bn'], m['arch_param_B'])
    syms = b * m['num_chan_bn'] * (h // 8) * (w // 8)
    cm = syms * counts.cm_flops_per_symbol(m['kernel_size'], m['arch_param__k'], m['num_centers'])
    return {'step_min_s': 3 * (b * (enc + dec) + cm) / (pk['f32_tflops'] * 1e12)}


def release(ctx: Ctx) -> None:
    if ctx.pipeline is not None:
        ctx.pipeline.stop()


def numbers(ctx: Ctx, samples, timing=None) -> Dict:
    """The check's numbers (rank 0 on several cards: the reference over the
    global batches)."""
    t = time.perf_counter()
    batches = [b.to(ctx.device) for b in ctx.batches]
    reference = judge_train.reference_run(ctx.weights.ae, ctx.weights.pc, batches,
                                          hyper(ctx.cfg))
    if timing is not None:
        timing['reference_steps'] = time.perf_counter() - t
    return judge_train.numbers(ctx.checked, reference, ctx.replica_gap)


def control_numbers(ctx: Ctx, samples) -> Dict:
    """The check's numbers for the reference in TF32 in the program's place
    (one replica: on several cards its replica gap is 0)."""
    batches = [b.to(ctx.device) for b in ctx.batches]
    hp = hyper(ctx.cfg)
    reference = judge_train.reference_run(ctx.weights.ae, ctx.weights.pc, batches, hp)
    control = judge_train.reference_run(ctx.weights.ae, ctx.weights.pc, batches, hp, 'tf32')
    return judge_train.numbers(control, reference, None if ctx.group is None else 0.0)


@contextlib.contextmanager
def half_batch():
    """Fault: the step's loss is the mean over the first half of the batch."""
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib
    loss_fn = trainer_lib.Trainer.loss_fn
    trainer_lib.Trainer.loss_fn = lambda self, state, batch: loss_fn(
        self, state, batch[:batch.shape[0] // 2])
    try:
        yield
    finally:
        trainer_lib.Trainer.loss_fn = loss_fn


@contextlib.contextmanager
def no_grad_all_reduce():
    """Fault: the gradients are not averaged over the ranks (the program's
    all_reduce_grads does nothing), so each rank steps on its own."""
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    all_reduce_grads = mesh_lib.all_reduce_grads
    mesh_lib.all_reduce_grads = lambda params, mesh: None
    try:
        yield
    finally:
        mesh_lib.all_reduce_grads = all_reduce_grads


FAULTS = {'half_batch': half_batch, 'no_grad_all_reduce': no_grad_all_reduce}
CHECKED_IN_SETUP = True
