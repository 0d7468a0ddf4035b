"""Idle ms a batch of the card while the host is in the planar codec's bias
rows (program span ``planar.bias_rows``: the per-image, per-plane
F.conv2d launches of encode's levels and decode's planes)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('planar.bias_rows',))
