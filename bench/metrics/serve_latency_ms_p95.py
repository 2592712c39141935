"""95th percentile (nearest rank) over every request of the window of
its own ``latency_s``: from the ``render`` call that carried it to its
finished frame, the wait behind the round's other requests included."""
from bench.metrics._stats import percentile


def read(obs):
    return 1e3 * percentile(obs["latency_s"], 95.0)
