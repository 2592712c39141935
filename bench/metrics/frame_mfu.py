"""The whole frame's share of the card's float32 peak: the window's
operations, counted as the two rooflines count them, over the window's
wall time x 67 TFLOP/s."""
from bench.metrics._work import PEAK_FP32


def read(obs):
    work = obs.get("work")
    if not work:
        return None
    flop = sum(w["probe_flop"] + w["march_flop"] for w in work)
    return 100.0 * flop / (obs["window_s"] * PEAK_FP32)
