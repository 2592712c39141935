"""The traced window: ``torch.profiler`` over the device's activity alone
(tracing the host's operations too would slow the frames it measures),
reduced to what the per-layer readers and the result's ``breakdown``
take: each kernel's device seconds and launches, the seconds in which
any operation ran on the device, and the idle gaps between device
operations, named by the operations on either side of them.
"""
from __future__ import annotations

import contextlib
import time

TOP = 10


def short_name(name: str) -> str:
    """``void (anonymous namespace)::fused_march_kernel<2>(float const*,
    ...)`` -> ``fused_march_kernel<2>``."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


@contextlib.contextmanager
def traced(enabled: bool, device):
    """Yields a dict that holds, after the block, the reduced trace
    (``summarize``), or stays empty when not ``enabled``."""
    out: dict = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    out.update(summarize(prof, window) if device.type == "cuda"
               else {"window_s": window})


def busy_spans(evs):
    """Merged busy spans of the sorted device events ``evs`` (start, end,
    name): [start, end, first operation, operation that ends it]."""
    spans = []
    for s, e, name in evs:
        if spans and s <= spans[-1][1]:
            if e >= spans[-1][1]:
                spans[-1][1], spans[-1][3] = e, name
        else:
            spans.append([s, e, name, name])
    return spans


def summarize(prof, window_s: float) -> dict:
    from torch.autograd import DeviceType

    evs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(),
                   short_name(e.name()))
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() != DeviceType.CPU), key=lambda t: t[0])
    kernels: dict = {}
    launches: dict = {}
    for s, e, name in evs:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
        launches[name] = launches.get(name, 0) + 1
    spans = busy_spans(evs)
    busy = sum(e - s for s, e, _, _ in spans) * 1e-9
    gaps: dict = {}
    for before, after in zip(spans, spans[1:]):
        key = f"{before[3]} -> {after[2]}"
        gaps[key] = gaps.get(key, 0.0) + (after[0] - before[1]) * 1e-9
    return {
        "window_s": window_s,
        "busy_s": busy,
        "kernels": kernels,
        "launches": launches,
        "device_ops": sorted(([k, v] for k, v in kernels.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def kernel_seconds(trace: dict, *names: str) -> float:
    """Device seconds of the kernels whose names hold any of ``names``;
    0.0 when none ran."""
    return sum(v for k, v in trace.get("kernels", {}).items()
               if any(n in k for n in names))
