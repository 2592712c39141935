"""Device milliseconds a frame of Phase II's one launch, the fused
march, from the traced window."""
from bench.devtrace import kernel_seconds


def read(obs):
    s = kernel_seconds(obs["trace"], "fused_march")
    return 1e3 * s / obs["frames"] if s > 0 else None
