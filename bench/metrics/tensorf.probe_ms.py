"""Device milliseconds a frame of Phase I on the VM field (library
operations: ``grid_sample`` and matmuls): the ``device_ms`` of the
``frame.probe`` spans (core/pipeline.py ``render_asdr_image``) of the
traced window."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "frame.probe", spans, device=True)
