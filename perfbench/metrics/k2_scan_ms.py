"""Device ms a unit (a batch) of kernel 2's scan, ``wavefront_kernel``
(csrc/wavefront_forward.cu: the decode, one image over a cluster of
blocks), from the device trace."""

KERNELS = r'\bwavefront_kernel\b'


def read(t):
    s = t.device_s(pattern=KERNELS)
    return 1e3 * s / t.units if t.units and s > 0 else None
