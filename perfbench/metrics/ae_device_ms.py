"""Device ms a unit (a batch, or a request: CodecModel._enc and _dec,
wrapped) of the kernels launched inside the harness's AE spans."""

SPANS = ('ae_encode', 'ae_decode')


def read(t):
    s = t.device_s(SPANS)
    return 1e3 * s / t.units if t.units and s > 0 else None
