#!/usr/bin/env python
"""Materialize a deterministic 1/f^2 natural-statistics image set as
PNGs (data/natural.py), for CLIs that take image directories:
`val_torch.py`, `eval/other_codecs.py`, `tools/codec_cli.py`. Port of
imgcomp_cvpr_tpu/tools/gen_natural_set.py: the same PNG bytes.

`natkodak24` (work_rd/natkodak24) = 24 images at the Kodak geometry
(768x512), generated by

    python -m imgcomp_cvpr_tpu_torch.tools.gen_natural_set natkodak24/ \
        --n 24 --hw 512x768 --offset 10000

The index offset keeps the evaluation set disjoint from demo-training
content (`-dtrain natural:N` uses indices 0..N-1; the seed also folds in
the image geometry). Regeneration is bit-identical anywhere, so the PNGs
themselves need not be committed.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('out_dir')
    p.add_argument('--n', type=int, default=24)
    p.add_argument('--hw', default='512x768', help='HxW, default 512x768')
    p.add_argument('--offset', type=int, default=10000,
                   help='first image index (keep val sets disjoint from '
                        'training indices 0..N-1)')
    flags = p.parse_args(argv)

    from PIL import Image

    from ..data import natural

    h, w = (int(v) for v in flags.hw.lower().split('x'))
    os.makedirs(flags.out_dir, exist_ok=True)
    for i in range(flags.n):
        idx = flags.offset + i
        img = natural.natural_image(idx, h, w)
        path = os.path.join(flags.out_dir, f'nat{idx:05d}.png')
        Image.fromarray(img).save(path)
        print(path)


if __name__ == '__main__':
    main()
