"""Share of the traced window in which no kernel ran on the card."""


def read(t):
    if t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
