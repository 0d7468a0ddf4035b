"""NCCL kernels a step (names that start with ``nccl``) on rank 0's card:
one a collective, the batch's broadcast and the loss's all-reduces, which
bucketing the all-reduces would lower."""

import re

KERNELS = re.compile(r'^nccl')


def read(t):
    n = sum(1 for name, _, _, _ in t.kernels if KERNELS.search(name))
    return n / t.units if t.units and n else None
