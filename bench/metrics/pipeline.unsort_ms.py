"""Device milliseconds a frame of the unsort (the march's outputs back
in ray order, and the frame's stats): the ``device_ms`` (CUDA events on
the frame's stream) of the ``frame.unsort`` spans (core/pipeline.py
``render_asdr_image``) of the traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "frame.unsort", spans, device=True)
