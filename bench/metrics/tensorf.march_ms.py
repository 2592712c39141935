"""Device milliseconds a frame of the VM field's Phase II, the VM march
kernel (``vm_march_kernel``), from the traced window."""
from bench.devtrace import kernel_seconds


def read(obs):
    s = kernel_seconds(obs["trace"], "vm_march")
    return 1e3 * s / obs["frames"] if s > 0 else None
