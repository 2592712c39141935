"""Camera poses from a traffic file's parameters and the seed.

Poses follow the R2 low-discrepancy sequence over (theta, phi) from a
fixed start, one sequence a stream (a scene of a server, the warm-up),
so the poses cover the orbit band evenly.  The seed orders them: it
shuffles each run of ``cycle`` consecutive poses, so every seed renders
the same poses, run by run, in another order, and a seed changes the
order of the work and not the work (a server's round takes one such run
a scene).  ``phi`` is uniform in its range (``"phi_sampling":
"uniform"``) or uniform over the sphere's area in that band
(``"sphere"``), which spreads the poses evenly: the first 150 poses of
the serve cells' streams lie at least 4.7 degrees apart, beyond the
probe tier's reach (4 degrees, 0.08 of eye travel).
"""
from __future__ import annotations

import math

import numpy as np

# 1/g and 1/g^2 for the plastic number g: the R2 sequence's steps.
_G = 1.32471795724474602596
R2_STEPS = (1.0 / _G, 1.0 / (_G * _G))


def seeded_rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for ``seed`` and a stream of small ints, so each
    use of the seed draws its own numbers."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def r2_poses(traffic: dict, seed: int, n: int, stream: int = 0):
    """The first ``n`` (theta, phi) pairs of stream ``stream``'s poses,
    each run of ``traffic["cycle"]`` shuffled by ``seed``."""
    cycle = traffic["cycle"]
    runs = -(-n // cycle)
    u0, v0 = seeded_rng(0, 1, stream).random(2)
    shuffle = seeded_rng(seed, 2, stream)
    k = np.concatenate([r * cycle + shuffle.permutation(cycle)
                        for r in range(runs)]).astype(np.float64)[:n]
    u = (u0 + k * R2_STEPS[0]) % 1.0
    v = (v0 + k * R2_STEPS[1]) % 1.0
    t_lo, t_hi = traffic["theta"]
    p_lo, p_hi = traffic["phi"]
    theta = t_lo + (t_hi - t_lo) * u
    if traffic.get("phi_sampling", "uniform") == "sphere":
        s_lo, s_hi = math.sin(p_lo), math.sin(p_hi)
        phi = np.arcsin(s_lo + (s_hi - s_lo) * v)
    else:
        phi = p_lo + (p_hi - p_lo) * v
    return list(zip(theta.tolist(), phi.tolist()))
