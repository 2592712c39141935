"""Host milliseconds a delivered frame of finishing it: the
``slot.finalize`` spans (serve/render_engine.py ``_finalize``:
``Slot.finalize``'s un-permute and the radiance store) of the traced
window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "slot.finalize", spans)
