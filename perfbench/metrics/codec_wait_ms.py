"""Host ms a batch that the codec's finish calls wait for their batch's
device work (program span ``codec.wait``: the event waits and the
stream-word re-copy): the host's slack in the pipeline."""

from perfbench import program_spans


def read(t):
    return program_spans.host_ms(t, ('codec.wait',))
