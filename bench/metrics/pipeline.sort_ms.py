"""Device milliseconds a frame of the block sort (rays padded to whole
blocks, sorted by count, gathered into block order): the ``device_ms``
(CUDA events on the frame's stream) of the ``frame.sort`` spans
(core/pipeline.py ``render_asdr_image``) of the traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "frame.sort", spans, device=True)
