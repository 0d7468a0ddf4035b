"""Idle ms a step of the card while the host is in the training backward
(program span ``train.backward``: autograd's launches)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('train.backward',))
