"""Device milliseconds a frame of Phase I's launches (the hash encode,
the density chain and the colour chain on the probe rows), from the
traced window."""
from bench.devtrace import kernel_seconds
from bench.metrics._stats import PROBE_KERNELS


def read(obs):
    s = kernel_seconds(obs["trace"], *PROBE_KERNELS)
    return 1e3 * s / obs["frames"] if s > 0 else None
