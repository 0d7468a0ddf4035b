"""Kernel 2 (csrc/wavefront_forward.cu: the layer-parallel encode, its
tables and the decode scan) against its roofline: the least time of its
work a unit (roofline/counts.py) over its device time a unit (a batch or a
request)."""

KERNELS = r'\b(encode_layer_kernel|encode_tables_kernel|wavefront_kernel)\b'


def read(t):
    s = t.device_s(pattern=KERNELS)
    if not t.units or s <= 0 or 'k2_bound_s' not in t.work:
        return None
    return 100.0 * t.work['k2_bound_s'] * t.units / s
