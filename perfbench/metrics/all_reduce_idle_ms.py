"""Idle ms a step of the card while the host is in the gradients'
all-reduce (program span ``train.all_reduce``: the flat copy, NCCL's
all-reduce and the copy back, on several cards only)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('train.all_reduce',))
