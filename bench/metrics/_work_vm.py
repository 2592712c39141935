"""The work of a TensoRF VM frame and the least time the card could take
for it, as ``_work.py`` reckons an Instant-NGP frame's: the operations and
bytes behind ``tensorf.march_roofline`` and the VM cell's ``frame_mfu``.

Operations, in fp32 (peaks and ``bound_s`` from ``_work.py``):

- a tap of one channel of a plane / line pair (``PAIR_FLOP``): the
  plane's four corners (4 products, 3 sums), the line's two (2, 1) and
  the product of the two;
- density, every sample within the budget of each chunk a block ran:
  each of the three pairs' ``cd`` channels and the sum over them;
- appearance, every anchor the march evaluates (``march_counts``: each
  anchor at or before a chunk's last valid sample, and the next where
  that sample lerps towards it): the three pairs' ``ca`` channels, the
  basis, the PE's sines and cosines and the biased chain.

Bytes: each input once (the four tensors, the basis and chain, each
ray's origin, direction and view rows, the budgets) and each output
once (the march's rows); every gather beyond the first read of a tensor
is not counted.  Phase I runs the same field through library operations
on every probe sample: density and appearance at each.
"""
from __future__ import annotations

import numpy as np

from bench.metrics._work import MARCH_OUT_FLOATS, bound_s

PAIR_FLOP = 4 + 3 + 2 + 1 + 1
# a sample's coordinates: three normalizations and per pair three texel
# coordinates (4 operations each) and four corner weights (2 each)
COORD_FLOP = 3 * 2 + 3 * (3 * 4 + 4 * 2)


def widths(cfg: dict):
    t = cfg["tensorf"]
    cd, ca = t["density_components"][0], t["app_components"][0]
    app, hid = t["app_dim"], t["hidden"]
    mlp_in = app + 3 + 2 * t["fea_pe"] * app + 2 * t["view_pe"] * 3
    return cd, ca, app, hid, mlp_in


def density_flop(cfg: dict) -> int:
    cd = widths(cfg)[0]
    return COORD_FLOP + 3 * cd * (PAIR_FLOP + 1) + 3


def appearance_flop(cfg: dict) -> int:
    cd, ca, app, hid, mlp_in = widths(cfg)
    fea_pe = cfg["tensorf"]["fea_pe"]
    chain = 2 * (mlp_in * hid + hid * hid + hid * 3) + 2 * hid + 3
    return (COORD_FLOP + 3 * ca * PAIR_FLOP + 2 * 3 * ca * app
            + 2 * app * fea_pe + chain + 3)


def tensor_floats(cfg: dict) -> int:
    t = cfg["tensorf"]
    r = t["resolution"]
    pairs = ((0, 1, 2), (0, 2, 1), (1, 2, 0))
    cd, ca, app, hid, mlp_in = widths(cfg)
    grid = sum((r[a] * r[b] + r[v]) for a, b, v in pairs) * (cd + ca)
    return grid + 3 * ca * app + mlp_in * hid + hid * hid + hid * 3 + 2 * hid + 3


def chunk_anchors(valid, chunk: int, group: int):
    """Anchors a chunk with ``valid`` samples within the budget evaluates."""
    A = -(-chunk // group)
    last = (valid - 1) // group
    extra = ((valid - 1) % group != 0) & (last + 1 < A)
    return np.where(valid > 0, last + 1 + extra, 0)


def march_counts(budgets, chunks, block: int, chunk: int, group: int):
    """(samples, anchors) of a VM march launch: for each block, the
    samples within its budget of each chunk it ran and the anchors those
    chunks evaluate, for every ray of the block."""
    bud = np.asarray(budgets, np.int64)
    runs = np.asarray(chunks, np.int64)
    samples = anchors = 0
    for ci in range(int(runs.max(initial=0))):
        v = np.where(runs > ci, np.clip(bud - ci * chunk, 0, chunk), 0)
        samples += int(v.sum()) * block
        anchors += int(chunk_anchors(v, chunk, group).sum()) * block
    return samples, anchors


def march_cost(cfg: dict, n_blocks: int, samples: int, anchors: int):
    """(flop, bytes) of a VM march launch."""
    t = cfg["tensorf"]
    flop = samples * density_flop(cfg) + anchors * appearance_flop(cfg)
    rays = n_blocks * cfg["asdr"]["block_size"]
    view = 3 + 6 * t["view_pe"]
    nbytes = 4 * (rays * (2 * 3 + view + MARCH_OUT_FLOATS) + n_blocks
                  + tensor_floats(cfg))
    return flop, nbytes


def probe_cost(cfg: dict):
    """(flop, bytes) of Phase I: density and appearance on every probe
    sample, the tensors read once, each sample's sigma and rgb written."""
    h, w = cfg["image_hw"]
    st = cfg["asdr"]["probe_stride"]
    n = -(-h // st) * -(-w // st) * cfg["asdr"]["ns_full"]
    flop = n * (density_flop(cfg) + appearance_flop(cfg))
    nbytes = 4 * (n * (3 + 3 + 1 + 3) + tensor_floats(cfg))
    return flop, nbytes


def frame_work(cfg: dict, budgets, chunks, probe_samples: int) -> dict:
    """One VM frame's samples, anchors, operations and bounds (seconds),
    under the keys ``_work.frame_work`` gives."""
    a = cfg["asdr"]
    samples, anchors = march_counts(budgets, chunks, a["block_size"],
                                    a["chunk"], a["group"])
    m_flop, m_bytes = march_cost(cfg, len(budgets), samples, anchors)
    p_flop, p_bytes = probe_cost(cfg)
    return {"probe_samples": probe_samples, "samples": samples,
            "anchors": anchors,
            "pixels": cfg["image_hw"][0] * cfg["image_hw"][1],
            "march_flop": m_flop, "march_bound_s": bound_s(m_flop, m_bytes),
            "probe_flop": p_flop, "probe_bound_s": bound_s(p_flop, p_bytes)}
