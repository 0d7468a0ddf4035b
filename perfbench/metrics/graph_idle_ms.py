"""Idle ms a step of the card while the host is in the training step's
CUDA graph (program span ``train.graph``: the copy of the batch into the
graph's input buffer, the replay and the copy of its outputs). A program
without the span reads nothing."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('train.graph',))
