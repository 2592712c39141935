"""Phase I's kernels' share of their roofline: the least time the card
could take for the hash encode, density chain and colour chain on the
probe rows (``_work.probe_cost``) over their device time."""
from bench.devtrace import kernel_seconds
from bench.metrics._stats import PROBE_KERNELS


def read(obs):
    s = kernel_seconds(obs["trace"], *PROBE_KERNELS)
    if s <= 0 or not obs.get("work"):
        return None
    return 100.0 * sum(w["probe_bound_s"] for w in obs["work"]) / s
