"""The work a frame needs and the least time the card could take for it:
the operations and bytes that the rooflines and ``frame_mfu`` use.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s in
float32 outside the tensor cores, where the port's kernels compute, and
3.35 TB/s of HBM3.  A kernel's bound is the larger of its operations at
the first and its bytes at the second; each input byte is counted once
and each output byte once.  Where the work depends on the data (a block
stops marching once its rays saturate), it counts what these inputs
needed: the samples of the chunks each block ran, within its budget.
"""
from __future__ import annotations

import numpy as np

from bench.reference import ngp

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# fp32 operations of one trilinear encode of one point at one level: 3
# scales and 3 fractions, then per corner 2 weight products and F
# multiply-adds at F = 2.
ENCODE_FLOP = 6 + 8 * (2 + 2 * 2)
# The fused march's output row: acc, rgb, depth, block chunks, ray chunks
# and one spare float.
MARCH_OUT_FLOATS = 8


def bound_s(flop: float, nbytes: float) -> float:
    return max(flop / PEAK_FP32, nbytes / PEAK_BYTES)


def widths(cfg: dict):
    """(levels, features, table rows, density widths, colour widths)."""
    g = cfg["grid"]
    return (g["n_levels"], g["feature_dim"], ngp.table_rows(cfg),
            *ngp.mlp_sizes(cfg))


def chain_flop(sizes) -> int:
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


def chain_floats(sizes) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def march_samples(budgets, chunks, block: int, chunk: int, group: int):
    """(samples, anchors) a fused-march launch needed: for each block,
    the samples within its budget of each chunk it ran, for every ray of
    the block (rays do not stop on their own), and the colour anchors
    among them, one each ``group`` samples of a chunk."""
    bud = np.asarray(budgets, np.int64)
    runs = np.asarray(chunks, np.int64)
    samples = anchors = 0
    for ci in range(int(runs.max(initial=0))):
        v = np.where(runs > ci, np.clip(bud - ci * chunk, 0, chunk), 0)
        samples += int(v.sum()) * block
        anchors += int((-(-v // group)).sum()) * block
    return samples, anchors


def march_cost(cfg: dict, n_blocks: int, samples: int, anchors: int):
    """(flop, bytes) of a fused-march launch over ``n_blocks`` blocks:
    encode and density chain on every sample, colour chain on each
    anchor; rays, SH features and output rows once, budgets, the tables
    and both weight chains once."""
    L, F, T, density, color = widths(cfg)
    flop = (samples * (L * ENCODE_FLOP + chain_flop(density))
            + anchors * chain_flop(color))
    rays = n_blocks * cfg["asdr"]["block_size"]
    sh = cfg["mlp"]["sh_degree"] ** 2
    nbytes = 4 * (rays * (2 * 3 + MARCH_OUT_FLOATS + sh) + n_blocks
                  + L * T * F + chain_floats(density) + chain_floats(color))
    return flop, nbytes


def probe_cost(cfg: dict):
    """{kernel: (flop, bytes)} of Phase I's launches: the hash encode,
    the density chain and the colour chain on every probe sample."""
    L, F, T, density, color = widths(cfg)
    h, w = cfg["image_hw"]
    st = cfg["asdr"]["probe_stride"]
    n = -(-h // st) * -(-w // st) * cfg["asdr"]["ns_full"]
    return {
        "hash_encode": (n * L * ENCODE_FLOP,
                        4 * (n * 3 + n * L * F + L * T * F + L * 3)),
        "density_mlp": (n * chain_flop(density),
                        4 * (n * (density[0] + density[-1])
                             + chain_floats(density))),
        "color_mlp": (n * chain_flop(color),
                      4 * (n * (color[0] + color[-1]) + chain_floats(color))),
    }


def frame_work(cfg: dict, budgets, chunks, probe_samples: int) -> dict:
    """One frame's samples, operations and bounds (seconds)."""
    a = cfg["asdr"]
    samples, anchors = march_samples(budgets, chunks, a["block_size"],
                                     a["chunk"], a["group"])
    m_flop, m_bytes = march_cost(cfg, len(budgets), samples, anchors)
    probe = probe_cost(cfg)
    return {"probe_samples": probe_samples, "samples": samples,
            "anchors": anchors, "pixels": cfg["image_hw"][0]
            * cfg["image_hw"][1],
            "march_flop": m_flop, "march_bound_s": bound_s(m_flop, m_bytes),
            "probe_flop": sum(f for f, _ in probe.values()),
            "probe_bound_s": sum(bound_s(f, b) for f, b in probe.values())}
