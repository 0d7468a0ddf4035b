"""Idle ms a step of the card while the host is in the optimizer's update
(program span ``train.optimizer``: the three Adam groups)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('train.optimizer',))
