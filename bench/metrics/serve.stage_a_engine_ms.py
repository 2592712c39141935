"""Host milliseconds a delivered frame of Stage A run on the engine's own
thread: the ``stage_a.prepare`` spans (serve/admission.py ``prepare``) on
the engine lane, the lane of the ``pool.dispatch_round`` spans, in the
traced window; Stage A on the workers' lanes is left out."""
from bench.metrics._spans import ms_a_frame


def read(obs, spans=None):
    return ms_a_frame(obs, "stage_a.prepare", spans, engine=True)
