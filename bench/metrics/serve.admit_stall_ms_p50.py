"""Median over every request of the window of the time its admission
blocked the engine thread (``admit_stall_s``, serve/admission.py)."""
from bench.metrics._stats import percentile


def read(obs):
    return 1e3 * percentile(obs["admit_stall_s"], 50.0)
