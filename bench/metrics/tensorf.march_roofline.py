"""The VM march's share of its roofline: the least time the card could
take for the window's marches (``_work_vm.march_cost`` on the samples and
anchors each frame's counters say it needed) over the kernel's device
time."""
from bench.devtrace import kernel_seconds


def read(obs):
    s = kernel_seconds(obs["trace"], "vm_march")
    if s <= 0 or not obs.get("work"):
        return None
    return 100.0 * sum(w["march_bound_s"] for w in obs["work"]) / s
