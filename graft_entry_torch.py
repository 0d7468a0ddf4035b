"""Top-level entry points of the PyTorch/CUDA port (counterpart of the JAX
package's __graft_entry__.py).

- entry(): one forward step of the flagship model (ae cvpr/low + pc
  cvpr/res_shallow, seeded weights) on a (1, 64, 64, 3) image: AE encode ->
  context-model bitcost -> AE decode -> (x_out, bpp). On the card unless
  the caller asks for the CPU.
- dryrun_multichip(n): one data-parallel training step of the tiny configs
  over n ranks (parallel/mesh.py) at batch n, crop 64; the trained state's
  evaluation (EvalModel.fetch_many) over n devices; a LatentCodec round
  trip of n + 1 latents (a batch n does not divide) over n devices,
  CRC-verified bit-exact. The ranks and devices are n cards when the
  machine has them, else n gloo ranks on the CPU, the way the JAX version
  falls back to a virtual CPU mesh.

Usage: ``python graft_entry_torch.py`` runs entry() on the card and
dryrun_multichip over the cards there are; ``python -c "import
graft_entry_torch as g; g.dryrun_multichip(2)"`` runs two gloo ranks on the
CPU of a machine without cards.
"""

import numpy as np
import torch


def _configs(tiny: bool = False):
    from imgcomp_cvpr_tpu_torch.utils import config as config_lib
    ae, _ = config_lib.parse_spec('cvpr/low', 'ae')
    pc, _ = config_lib.parse_spec('cvpr/res_shallow', 'pc')
    if tiny:
        ae = ae.replace(arch_param_B=1, num_chan_bn=8)
        pc = pc.replace(arch_param__k=8)
    return ae, pc


def entry(device='cuda'):
    """-> (fn, example_args); fn(ae, pc, x) is one forward step of the
    flagship model: AE encode -> context-model bitcost -> AE decode,
    returning (x_out (1, 64, 64, 3), bpp). The modules' weights come from
    explicit torch.Generators (AE seed 0, context model seed 1)."""
    from imgcomp_cvpr_tpu_torch import resolve_device
    from imgcomp_cvpr_tpu_torch.models import autoencoder as ae_lib
    from imgcomp_cvpr_tpu_torch.models import probclass as pc_lib

    dev = resolve_device(device)
    ae_config, pc_config = _configs()
    ae = ae_lib.init_params(ae_lib.get_network_cls(ae_config)(ae_config, device=dev), seed=0)
    pc = pc_lib.init_params(pc_lib.ProbClassifier(pc_config, ae_config.num_centers,
                                                  device=dev), seed=1)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3)
                         .astype(np.float32) * 255.0).to(dev)

    @torch.no_grad()
    def fn(ae, pc, x):
        enc, x_out = ae(x, False)
        pad = pc_lib.auto_pad_value(pc.config, ae.encoder.centers, pc)
        bc = pc.bitcost(enc.qbar, enc.symbols, pad)
        bpp = bc.sum() / float(x.shape[0] * x.shape[1] * x.shape[2])
        return x_out, bpp

    return fn, (ae, pc, x)


def _train_rank(rank, devices, init_method):
    """One rank of the data-parallel train step (for mesh.spawn, or in this
    process at world 1), on devices[rank]: the tiny configs at batch
    len(devices), crop 64, this rank's slice of a seeded batch. Returns
    (loss, step, the modules' state dicts on the host)."""
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
    from imgcomp_cvpr_tpu_torch.training import trainer as trainer_lib

    world = len(devices)
    mesh = mesh_lib.init_process_group(rank, world, devices[rank], init_method)
    try:
        ae_config, pc_config = _configs(tiny=True)
        ae_config = ae_config.replace(batch_size=world, crop_size=(64, 64))
        t = trainer_lib.Trainer(ae_config, pc_config, num_train_images=1024, mesh=mesh)
        state = t.init_state(0)
        batch = np.random.RandomState(0).rand(world, 64, 64, 3).astype(np.float32) * 255.0
        state, comps = t.train_step(state, mesh_lib.shard_batch(batch, mesh))
        model = {part: {k: v.cpu() for k, v in mod.state_dict().items()}
                 for part, mod in (('ae', state.ae), ('pc', state.pc))}
        return float(comps['total_loss']), state.step, model
    finally:
        mesh_lib.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """One data-parallel train step over ``n_devices`` ranks, then the
    trained state's evaluation and a codec round trip over as many devices
    (see the module docstring). Raises on a non-finite loss or bpp and on a
    round trip that is not bit-exact; prints one line."""
    from imgcomp_cvpr_tpu_torch.coding import codec as codec_lib
    from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
    from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib

    n = int(n_devices)
    cards = torch.cuda.is_available() and torch.cuda.device_count() >= n
    devices = mesh_lib.device_list('cuda' if cards else 'cpu', n)
    init_method = f'tcp://localhost:{mesh_lib.free_port()}'
    if n == 1:
        loss, step, model = _train_rank(0, devices, init_method)
    else:
        loss, step, model = mesh_lib.spawn(_train_rank, n, (devices, init_method))
    if not np.isfinite(loss):
        raise AssertionError(f'dryrun_multichip: non-finite loss {loss}')

    ae_config, pc_config = _configs(tiny=True)
    em = validate_lib.EvalModel(ae_config, pc_config, device=devices)
    em.set_params(model)
    imgs = [(np.random.RandomState(i).rand(64, 64, 3) * 255).astype(np.uint8)
            for i in range(n)]
    outs = em.fetch_many(imgs)
    if len(outs) != n or not all(np.isfinite(float(o['bpp'])) for o in outs):
        raise AssertionError('dryrun_multichip: evaluation over the devices failed')

    codec = codec_lib.LatentCodec(em.pc, pc_config, device=em.devices)
    centers = em.ae.encoder.centers.detach().cpu().numpy()
    syms = np.stack([np.transpose(o['sym'], (2, 0, 1)) for o in outs]
                    + [np.transpose(outs[0]['sym'], (2, 0, 1))]).astype(np.int8)
    results = codec.encode_batch(syms, centers)
    decoded = codec.decode_batch([r.bitstream for r in results], centers, verify=True,
                                 device_out=False)
    np.testing.assert_array_equal(decoded, syms.astype(np.int32))
    where = f'{n} card(s)' if cards else f'{n} gloo ranks on the CPU'
    print(f'dryrun_multichip({n}): ok, loss={loss:.4f}, step={step}, '
          f'eval bpp={float(outs[0]["bpp"]):.3f} over {n} devices ({where}); '
          f'codec round trip CRC-verified bit-exact (batch {syms.shape[0]} over {n} '
          f'devices, {sum(len(r.bitstream) for r in results)} bytes)', flush=True)


if __name__ == '__main__':
    fn, args = entry()
    out, bpp = fn(*args)
    print('entry ok:', tuple(out.shape), float(bpp))
    dryrun_multichip(max(1, torch.cuda.device_count()))
