#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port (the command line of
train.py; ref: train.py:471-526). Runs on one CUDA card unless --device
says otherwise; --num_devices N trains data-parallel over N ranks
(training/train_loop.py).

    python train_torch.py cvpr/low cvpr/res_shallow -dtrain synthetic:64 \\
        -dtest synthetic:8 --max_steps 20 -ltrain 5 -ltest 10 -o logs_torch
"""

import argparse
import os
import time

from imgcomp_cvpr_tpu_torch.training import checkpoint as checkpoint_lib
from imgcomp_cvpr_tpu_torch.training import train_loop


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('autoencoder_config_path', help="e.g. 'cvpr/low' or a file path")
    p.add_argument('probclass_config_path', help="e.g. 'cvpr/res_shallow'")
    p.add_argument('--dataset_train', '-dtrain', default='imgnet_train')
    p.add_argument('--dataset_test', '-dtest', default='imgnet_test')
    p.add_argument('--dataset_codec_distance', '-dcodec', default='testset',
                   help='Dataset whose BPG curves (under $OTHER_CODECS_ROOT) '
                        'the d_BPG test monitor reads.')
    p.add_argument('--log_dir_root', '-o', default='logs', metavar='LOG_DIR_ROOT')
    p.add_argument('--log_interval_train', '-ltrain', type=int, default=100)
    p.add_argument('--log_interval_save', '-lsave', type=int, default=1000)
    p.add_argument('--log_interval_test', '-ltest', type=int, default=1000,
                   help='Set to -1 to skip testing.')
    p.add_argument('--max_steps', type=int, default=None)
    p.add_argument('--steps_per_dispatch', type=int, default=8,
                   help='Accepted and unused (a remote-dispatch workaround).')
    p.add_argument('--dispatch_timeout', type=float, default=900.0,
                   help='Accepted and unused (a remote-dispatch workaround).')
    p.add_argument('--profile_steps', type=int, default=None,
                   help='Capture a torch.profiler trace of N steps starting at step 10.')
    p.add_argument('--temporary', '-t', action='store_true',
                   help='Append _TMP to LOG_DIR_ROOT')
    p.add_argument('--from_identity', metavar='IDENTITY_CKPT_DIR',
                   help='Restore weights only; step and optimizer state are re-initialized.')
    p.add_argument('--restore', '-r', metavar='RESTORE_DIR',
                   help='Path to ckpt dir to restore from.')
    p.add_argument('--restore_itr', '-i', type=int, default=-1,
                   help='Iteration to restore (-1 = latest; else latest <= itr).')
    p.add_argument('--restore_continue', action='store_true',
                   help='Continue logging into the restored run log dir.')
    p.add_argument('--restore_skip_vars', type=str,
                   help="Comma-separated substrings of state paths to skip, "
                        "e.g. 'opt_state,step'.")
    p.add_argument('--ckpt_interval', type=float, default=1,
                   help='How often to keep checkpoints, in hours.')
    p.add_argument('--description', '-d', type=str, default='')
    p.add_argument('--seed', type=int, default=1234)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default; raises with no card) or 'cpu'.")
    p.add_argument('--num_devices', type=int, default=None,
                   help='Data-parallel over N ranks: cards cuda:0..N-1 (raises when '
                        'the machine has fewer), or N gloo ranks with --device cpu.')
    flags = p.parse_args(argv)

    if flags.temporary:
        print('*** WARN: --temporary')
        time.sleep(1.5)
        flags.log_dir_root = flags.log_dir_root.rstrip(os.path.sep) + '_TMP'

    train_flags = train_loop.TrainFlags(
        log_interval_train=flags.log_interval_train,
        log_interval_test=flags.log_interval_test,
        log_interval_save=flags.log_interval_save,
        max_steps=flags.max_steps,
        profile_steps=flags.profile_steps,
        steps_per_dispatch=flags.steps_per_dispatch,
        dispatch_timeout_s=flags.dispatch_timeout)

    return train_loop.train(
        flags.autoencoder_config_path, flags.probclass_config_path,
        dataset_train=flags.dataset_train, dataset_test=flags.dataset_test,
        dataset_codec_distance=flags.dataset_codec_distance,
        log_dir_root=flags.log_dir_root,
        restore_manager=checkpoint_lib.RestoreManager.from_flags(flags),
        flags=train_flags,
        ckpt_interval_hours=flags.ckpt_interval,
        description=flags.description if not flags.temporary else '',
        seed=flags.seed,
        device=flags.device,
        num_devices=flags.num_devices)


if __name__ == '__main__':
    main()
