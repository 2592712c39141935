"""Nearest-rank percentiles, as the port's ``obs/metrics.py`` takes them:
the smallest sample whose rank reaches q% of the count."""
from __future__ import annotations

import math


def percentile(xs, q: float) -> float:
    s = sorted(xs)
    rank = min(max(int(math.ceil(q / 100.0 * len(s))), 1), len(s))
    return float(s[rank - 1])


# Phase I's launches in a frame: every one of these runs on the probe rows.
PROBE_KERNELS = ("hash_encode", "density_mlp", "color_mlp")


def idle_share(obs):
    """Percent of the traced window with no device operation running."""
    tr = obs["trace"]
    if not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
