"""Device ms a step in NCCL's kernels (names that start with ``nccl``) on
rank 0's card: the collectives of the data-parallel step, the time an
all-reduce spins while it waits for the slowest rank included."""

KERNELS = r'^nccl'


def read(t):
    s = t.device_s(pattern=KERNELS)
    return 1e3 * s / t.units if t.units and s > 0 else None
