"""Host milliseconds a delivered frame the engine waits on the card for
a batch's outputs: the ``pool.fetch`` spans (serve/pool.py ``collect``:
the ``.cpu()`` of each output) of the traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "pool.fetch", spans)
