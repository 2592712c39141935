"""The server's pooled fused march's share of its roofline: the least
time the card could take for the window's batches (``_work.march_cost``
on the samples and anchors of each ``pool.collect`` span's real blocks,
from their ``budgets`` and marched ``chunks``; no colour anchors in a
density-only batch) over the device time of the window's
``fused_march`` kernels."""
from bench.devtrace import kernel_seconds
from bench.metrics import _work
from bench.metrics._spans import cell_config, recorded


def read(obs, spans=None, cfg=None):
    spans = recorded() if spans is None else spans
    collects = [s.attrs for s in spans or ()
                if s.name == "pool.collect" and "budgets" in s.attrs]
    s = kernel_seconds(obs["trace"], "fused_march")
    if not collects or s <= 0:
        return None
    cfg = cell_config() if cfg is None else cfg
    if cfg is None:
        return None
    a = cfg["asdr"]
    bound = 0.0
    for c in collects:
        samples, anchors = _work.march_samples(
            c["budgets"], c["chunks"], a["block_size"], a["chunk"],
            a["group"])
        bound += _work.bound_s(*_work.march_cost(
            cfg, len(c["budgets"]), samples,
            0 if c.get("density") else anchors))
    return 100.0 * bound / s
