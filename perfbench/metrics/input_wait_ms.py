"""Host ms a step that the harness waits for the next batch: the input
pipeline's queue (crops and flips of images held in memory) and the pinned
upload's enqueue (the 'fetch' span)."""


def read(t):
    s = t.host_spans.get('fetch')
    return 1e3 * s / t.units if t.units and s is not None else None
