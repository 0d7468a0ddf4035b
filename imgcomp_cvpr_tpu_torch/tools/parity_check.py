"""One-command A/B/C checkpoint parity harness (port of
imgcomp_cvpr_tpu/tools/parity_check.py; runs on one CUDA card unless
--device says otherwise).

The reference publishes three operating points on Kodak for its released
TF1 checkpoints (ref README.md:47-49, plotted in README.md:131-133):

    0515_1103 (ae cvpr/low + pc cvpr/res_shallow): 0.370 bpp / 0.975 MS-SSIM
    0515_1309 (ae cvpr/med + pc cvpr/res_shallow): 0.677 bpp / 0.987 MS-SSIM
    0515_1310 (ae cvpr/hi  + pc cvpr/res_shallow): 1.051 bpp / 0.992 MS-SSIM

The day a checkpoint is available, parity is ONE command:

    python -m imgcomp_cvpr_tpu_torch.tools.parity_check \
        /path/to/0515_1103/ckpts/ckpt-<itr> --images /path/to/kodak

The harness imports the TF1 variables (tools/tf1_import.py: pure Python, no
TensorFlow), runs the full Kodak sweep through the port's eval model
(eval/validate.py's EvalModel.fetch_many, in batches of eval_batch images of
one shape), prints mean bpp / MS-SSIM next to the published numbers, and
exits nonzero if either deviates more than --budget (default 0.5%, the
BASELINE.json budget).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# (config spec pair, published Kodak bpp, published Kodak MS-SSIM);
# keyed by the reference's checkpoint job ids (ref README.md:47-49).
KNOWN_CHECKPOINTS = {
    '0515_1103': (('cvpr/low', 'cvpr/res_shallow'), 0.370, 0.975),
    '0515_1309': (('cvpr/med', 'cvpr/res_shallow'), 0.677, 0.987),
    '0515_1310': (('cvpr/hi', 'cvpr/res_shallow'), 1.051, 0.992),
}


def detect_job_id(ckpt_path: str):
    for job_id in KNOWN_CHECKPOINTS:
        if job_id in ckpt_path:
            return job_id
    return None


def check_manifest(manifest_path: str, ae_spec: str, pc_spec: str) -> bool:
    """Validate the importer's name mapping against a var_names.pkl
    manifest ALONE (no tensor values needed; ref saver.py:19-43 pickles
    the variable-name list next to every checkpoint). A checkpoint
    manifest that arrives before/without the tensors can already prove
    the mapping is complete: every name the importer reads must be in
    the manifest, and every non-training-state manifest name must be
    consumed by the importer."""
    import pickle

    from ..utils import config as config_lib
    from ..parallel import mesh as mesh_lib
    from . import tf1_import

    ae_config, _ = config_lib.parse_spec(ae_spec, 'ae')
    with open(manifest_path, 'rb') as f:
        if manifest_path.endswith(('.txt', '.list')):
            names = f.read().decode().split()
        else:
            names = pickle.load(f)
    # tf variable names carry a ':0' output suffix; normalize it away
    have = {n.split(':')[0] for n in names}
    skipped = {n for n in have
               if any(s in n for s in tf1_import.SKIP_VAR_SUBSTRINGS)}
    want = set(tf1_import.expected_names(ae_config))
    missing = sorted(want - have)
    extra = sorted(have - skipped - want)
    print(f'manifest {manifest_path}: {len(have)} variables '
          f'({len(skipped)} training-state, skipped)')
    print(f'importer expects {len(want)} for ae={ae_spec} pc={pc_spec}')
    for n in missing:
        print(f'  MISSING from manifest: {n}')
    for n in extra:
        print(f'  UNMAPPED model variable: {n}')
    ok = not missing and not extra
    print('manifest check: ' + ('OK — the importer consumes this '
                                'checkpoint completely' if ok else 'FAIL'))
    return ok


def run_parity(ckpt_path: str, ae_spec: str, pc_spec: str, images: str,
               expected_bpp=None, expected_msssim=None, budget=0.005,
               eval_batch: int = 8, num_devices: int = 1, device='cuda'):
    from .. import weights as weights_lib
    from ..data import val_images
    from ..data.images_iterator import ImagesIterator
    from ..eval import validate as validate_lib
    from ..models import autoencoder as ae_lib
    from ..parallel import mesh as mesh_lib
    from ..utils import config as config_lib
    from . import tf1_import

    ae_config, _ = config_lib.parse_spec(ae_spec, 'ae')
    pc_config, _ = config_lib.parse_spec(pc_spec, 'pc')
    params, batch_stats = tf1_import.import_tf1_checkpoint(
        ckpt_path, ae_config, pc_config)

    model = validate_lib.EvalModel(ae_config, pc_config,
                                   device=mesh_lib.device_list(device, num_devices))
    eval_batch *= num_devices        # eval_batch images on each device
    model.set_params({'ae': weights_lib.ae_state_dict(params['ae'], batch_stats, model.ae),
                      'pc': weights_lib.pc_state_dict(params['pc'])})

    image_paths, dataset_name = val_images.get_image_paths(images)
    it = ImagesIterator(image_paths, dataset_name, cache_max_mb=500)

    bpps, msssims, psnrs = [], [], []
    buf = []

    def flush():
        if not buf:
            return
        # one batch shape per image shape: cuDNN picks its algorithms by shape
        for otp in model.fetch_many([img for _, img in buf], pad_batch_to=eval_batch):
            bpps.append(float(otp['bpp']))
            msssims.append(float(otp['ms-ssim']))
            psnrs.append(float(otp['psnr']))
        buf.clear()

    for name, img in it.iter_imgs(pad=ae_lib.SUBSAMPLING_FACTOR):
        if buf and (img.shape != buf[0][1].shape or len(buf) >= eval_batch):
            flush()
        buf.append((name, img))
    flush()

    mean_bpp = float(np.mean(bpps))
    mean_msssim = float(np.mean(msssims))
    print(f'{len(bpps)} images: bpp={mean_bpp:.4f} ms-ssim={mean_msssim:.4f} '
          f'psnr={float(np.mean(psnrs)):.2f}')

    ok = True
    for label, got, want in (('bpp', mean_bpp, expected_bpp),
                             ('ms-ssim', mean_msssim, expected_msssim)):
        if want is None:
            continue
        rel = abs(got - want) / want
        status = 'OK' if rel <= budget else 'FAIL'
        if rel > budget:
            ok = False
        print(f'  {label}: got {got:.4f}, published {want:.4f} '
              f'({rel * 100:.2f}% off, budget {budget * 100:.1f}%) {status}')
    return ok, mean_bpp, mean_msssim


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('ckpt_path', nargs='?',
                   help='TF1 checkpoint prefix '
                        '(e.g. .../0515_1103/ckpts/ckpt-7627)')
    p.add_argument('--manifest-only', metavar='VAR_NAMES',
                   help='Validate the importer name mapping against a '
                        'var_names.pkl (or .txt name list) ALONE — no '
                        'tensors or images needed; a checkpoint manifest '
                        'can prove the mapping before the weights exist')
    p.add_argument('--images',
                   help='Kodak dir / glob / known dataset name')
    p.add_argument('--ae', help='AE config spec (auto-detected from known '
                                'checkpoint job ids in ckpt_path)')
    p.add_argument('--pc', help='PC config spec (auto-detected likewise)')
    p.add_argument('--expected_bpp', type=float)
    p.add_argument('--expected_msssim', type=float)
    p.add_argument('--budget', type=float, default=0.005,
                   help='Relative deviation budget (default 0.5%%)')
    p.add_argument('--num_devices', type=int, default=1,
                   help='Evaluate data-parallel over N devices (cards cuda:0..N-1, '
                        'or N copies on the CPU with --device cpu).')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises with no card) or 'cpu'.")
    flags = p.parse_args(argv)

    ae_spec, pc_spec = flags.ae, flags.pc
    expected_bpp, expected_msssim = flags.expected_bpp, flags.expected_msssim
    job_id = detect_job_id(flags.ckpt_path or flags.manifest_only or '')
    if job_id is not None:
        (auto_ae, auto_pc), pub_bpp, pub_msssim = KNOWN_CHECKPOINTS[job_id]
        ae_spec = ae_spec or auto_ae
        pc_spec = pc_spec or auto_pc
        expected_bpp = expected_bpp if expected_bpp is not None else pub_bpp
        expected_msssim = (expected_msssim if expected_msssim is not None
                           else pub_msssim)
        print(f'Recognized checkpoint {job_id}: ae={ae_spec} pc={pc_spec}, '
              f'published {pub_bpp} bpp / {pub_msssim} MS-SSIM')
    if ae_spec is None or pc_spec is None:
        p.error('--ae/--pc required for unrecognized checkpoint paths')

    if flags.manifest_only:
        return 0 if check_manifest(flags.manifest_only, ae_spec,
                                   pc_spec) else 1
    if not flags.ckpt_path or not flags.images:
        p.error('ckpt_path and --images required (or use --manifest-only)')
    ok, _, _ = run_parity(flags.ckpt_path, ae_spec, pc_spec, flags.images,
                          expected_bpp, expected_msssim, flags.budget,
                          num_devices=flags.num_devices, device=flags.device)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
