"""Device ms a batch of the kernels launched inside the entropy codec's
submit and finish spans."""

SPANS = ('codec_encode_submit', 'codec_encode_finish', 'codec_decode_submit',
         'codec_decode_finish')


def read(t):
    s = t.device_s(SPANS)
    return 1e3 * s / t.units if t.units and s > 0 else None
