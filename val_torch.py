#!/usr/bin/env python
"""Validation entry point of the PyTorch/CUDA port (the command line of
val.py, ref: val.py:265-302, plus --device). Runs on one CUDA card unless
--device says otherwise, or data-parallel over --num_devices cards
(eval/validate.py).

    python val_torch.py LOG_ROOT JOB_IDS work_rd/natkodak24 --real_bpp --save_ours

For every run of LOG_ROOT whose log date matches a job id, validates its
checkpoints on the images (a dataset alias under $VAL_ROOT, a directory of
PNGs or a glob) and writes '<log date> <dataset>/measures.csv' and
'summary_<itr>.json' under LOG_ROOT.
"""

import argparse

from imgcomp_cvpr_tpu_torch import resolve_device
from imgcomp_cvpr_tpu_torch.data import val_images
from imgcomp_cvpr_tpu_torch.data.images_iterator import ImagesIterator
from imgcomp_cvpr_tpu_torch.eval import validate as validate_lib
from imgcomp_cvpr_tpu_torch.eval.val_files import ValidationDirs
from imgcomp_cvpr_tpu_torch.parallel import mesh as mesh_lib
from imgcomp_cvpr_tpu_torch.utils import logdir as logdir_lib


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('log_dir_root', help='Path to dir containing log_dirs.')
    p.add_argument('job_ids', help='Comma-separated list of job_ids.')
    p.add_argument('images', help='Known dataset name, dir of PNGs, or glob.')
    p.add_argument('--save_ours', '-o', action='store_true',
                   help='Store output images in VAL_OUT/imgs.')
    p.add_argument('--how_many', type=int, help='Number of images to validate.')
    p.add_argument('--image_cache_max', '-cache', type=int, default=500,
                   help='Cache max in MB; 0 disables.')
    p.add_argument('--ckpt_step', '-s', type=int, default=2,
                   help='Validate every Nth checkpoint (+ last). -1 = only last.')
    p.add_argument('--reset', action='store_true', help='Remove previous output.')
    p.add_argument('--real_bpp', action='store_true',
                   help='Entropy-code each image for real (bit-exact round-trip '
                        'checked); prints real vs theoretical vs loss bpp.')
    p.add_argument('--num_devices', type=int, default=None,
                   help='Validate data-parallel over N devices: cards cuda:0..N-1 '
                        '(raises when the machine has fewer), or N copies on the '
                        'CPU with --device cpu; each device takes batches of 8.')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises with no card) or 'cpu'.")
    flags, unknown = p.parse_known_args(argv)
    if unknown:
        print(f'Unknown flags: {unknown}')
    dev = resolve_device(flags.device)
    if flags.num_devices is not None:
        dev = mesh_lib.device_list(dev, flags.num_devices)

    image_paths, dataset_name = val_images.get_image_paths(flags.images)
    images_iterator = ImagesIterator(image_paths[:flags.how_many], dataset_name,
                                     flags.image_cache_max)
    val_flags = validate_lib.OutputFlags(flags.save_ours, flags.ckpt_step,
                                         flags.real_bpp)
    for ckpt_dir in logdir_lib.iter_ckpt_dirs(flags.log_dir_root, flags.job_ids):
        try:
            validate_lib.validate(
                ValidationDirs(ckpt_dir, flags.log_dir_root, dataset_name,
                               flags.reset),
                images_iterator, val_flags, device=dev)
        except FileNotFoundError as e:
            print(f'*** Caught {e}')
            continue
    print('*** All given job_ids validated.')


if __name__ == '__main__':
    main()
