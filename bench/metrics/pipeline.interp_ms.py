"""Device milliseconds a frame of Phase I's interpolation (the probes'
sample counts and the per-pixel maps): the ``device_ms`` (CUDA events on
the frame's stream) of the ``frame.interpolate`` spans (core/pipeline.py
``render_asdr_image``) of the traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "frame.interpolate", spans, device=True)
