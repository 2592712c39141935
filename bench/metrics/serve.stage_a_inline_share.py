"""Share of the traced window's admissions whose Stage A ran on the
engine thread: ``admission.wait`` spans whose ``stage_a`` placement
(serve/executor.py ``last_take``) is ``inline`` (never submitted) or
``stolen`` (never started on a worker), over all admissions, %."""
from bench.metrics._spans import recorded


def read(obs, spans=None):
    spans = recorded() if spans is None else spans
    how = [s.attrs["stage_a"] for s in spans or ()
           if s.name == "admission.wait" and "stage_a" in s.attrs]
    if not how:
        return None
    return 100.0 * sum(h in ("inline", "stolen") for h in how) / len(how)
