"""Kernel 5 (csrc/plane_forward.cu: the level launches, the tables and the
plane scans) against its roofline: the least time of its work a batch, the
current plane's masked taps of both passes (the bias rows compute the
earlier planes'; roofline/counts.py), over its device time a batch."""

KERNELS = r'\b(plane_level_kernel|plane_tables_kernel|plane_kernel)\b'


def read(t):
    s = t.device_s(pattern=KERNELS)
    if not t.units or s <= 0 or 'k5_bound_s' not in t.work:
        return None
    return 100.0 * t.work['k5_bound_s'] * t.units / s
