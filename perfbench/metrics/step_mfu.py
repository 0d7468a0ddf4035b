"""The whole step's share of the card's peak: the least time its model
operations take at the peaks (roofline/counts.py through the runner's
``work``: a codec step's AE at the towers' precision and the context
model's encode and decode passes at float32; a training step's forward and
backward at float32), over all the units of the traced window, divided by
the window."""


def read(t):
    if t.window_s <= 0 or not t.units or not t.kernels or 'step_min_s' not in t.work:
        return None
    return 100.0 * t.work['step_min_s'] * t.units / t.window_s
