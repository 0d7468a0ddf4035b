"""Idle ms a request of the card while the host is in the AE's encode or
decode (program spans ``ae.encode``, ``ae.decode``: the towers' launches,
without the caller's upload and casts)."""

from perfbench import program_spans


def read(t):
    return program_spans.idle_ms(t, ('ae.encode', 'ae.decode'))
