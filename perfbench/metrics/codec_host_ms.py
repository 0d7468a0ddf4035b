"""Host ms a batch in the codec's container work: writing the streams
(program span ``codec.serialize``) and parsing and uploading them before
the decode is enqueued (``codec.parse``)."""

from perfbench import program_spans


def read(t):
    return program_spans.host_ms(t, ('codec.serialize', 'codec.parse'))
