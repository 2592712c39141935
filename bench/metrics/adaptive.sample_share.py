"""Adaptive sampling's share of the fixed-count work: Phase I's probe
samples plus the Phase-II samples within the block budgets of the chunks
each block ran, over pixels x ``ns_full``, summed over the window's
frames (the frames' own counters)."""


def read(obs):
    work = obs.get("work")
    if not work:
        return None
    spent = sum(w["probe_samples"] + w["samples"] for w in work)
    full = sum(w["pixels"] for w in work) * obs["ns_full"]
    return 100.0 * spent / full
