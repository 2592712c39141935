"""Percent of Phase I's device time spent in the VM field's appearance:
the ``device_ms`` of the ``tensorf.appearance`` spans (core/tensorf.py
``field_fns``; the march runs its appearance inside the kernel, so every
such span is the probe's) over that of the ``frame.probe`` spans."""
from bench.metrics._spans import ms_a_frame, recorded


def read(obs, spans=None):
    spans = recorded() if spans is None else spans
    app = ms_a_frame(obs, "tensorf.appearance", spans, device=True)
    probe = ms_a_frame(obs, "frame.probe", spans, device=True)
    if app is None or not probe:
        return None
    return 100.0 * app / probe
