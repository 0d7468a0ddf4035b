"""Idle ms a step of the card while the host is in the training forward
(program span ``train.forward``: AE, context model and loss)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('train.forward',))
