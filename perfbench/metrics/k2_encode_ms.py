"""Device ms a unit (a batch) of kernel 2's layer-parallel encode: its four
layer launches and its tables, ``encode_layer_kernel`` and
``encode_tables_kernel`` (csrc/wavefront_forward.cu), from the device
trace."""

KERNELS = r'\b(encode_layer_kernel|encode_tables_kernel)\b'


def read(t):
    s = t.device_s(pattern=KERNELS)
    return 1e3 * s / t.units if t.units and s > 0 else None
