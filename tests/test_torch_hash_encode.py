"""The hash encode's launch geometry and sector reckoning
(``kernels/hash_encode.py``), which the CUDA kernel follows and the chip
smoke prints: the level groups a work item covers, the order the kernel
walks them (every (point, level) exactly once, groups in order), and the
distinct-sector count of the warps' gathers held to a direct count at the
small config; then the wrapper's CPU path against the JAX Pallas kernel
(interpret mode) at point counts off the warp."""
import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.model import NGPConfig as JNGPConfig
from repro.kernels import ops as jops
from repro_torch.configs import ingp_asdr
from repro_torch.core import scene
from repro_torch.kernels import _build, tile_variants
from repro_torch.kernels import hash_encode as HE

RTOL, ATOL = 1e-4, 1e-5      # the port's float32 contract


@pytest.mark.parametrize("F,G", [(1, 8), (2, 4), (3, 2), (4, 2), (5, 1),
                                 (8, 1)])
def test_levels_per_group_fill_one_sector(F, G):
    assert HE.levels_per_group(F) == G
    assert G * F <= HE.GROUP_FLOATS or G == 1


@pytest.mark.parametrize("const", list(tile_variants.MIRRORS))
def test_wrapper_mirrors_the_kernel_constants(const):
    """The launch geometry the wrapper reckons uses the kernel's own
    group width and lanes a point."""
    mod, attr = tile_variants.MIRRORS[const]
    text = (_build.CSRC / f"{mod}.cu").read_text()
    value = re.findall(rf"constexpr int {const} = (\d+);", text)
    wrapper = importlib.import_module(f"repro_torch.kernels.{mod}")
    assert [int(v) for v in value] == [getattr(wrapper, attr)]


@pytest.mark.parametrize("F", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("L", [1, 5, 16])
@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_work_items_cover_every_point_level_once(n, L, F):
    """Item i is point i % n of group i // n: enumerated one by one, the
    items give each (point, level) exactly once, the groups run in order
    over consecutive levels, and all items of a group come before the
    next group's."""
    items = HE.work_items(n, L, F)
    G = HE.levels_per_group(F)
    assert [g for g, _, _ in items] == list(range(len(items)))
    assert [l0 for _, l0, _ in items] == list(range(0, L, G))
    assert all(1 <= k <= G for _, _, k in items)
    seen, groups = [], []
    for i in range(n * len(items)):
        g, p = divmod(i, n)
        _, l0, k = items[g]
        groups.append(g)
        seen += [(p, l) for l in range(l0, l0 + k)]
    assert sorted(seen) == [(p, l) for p in range(n) for l in range(L)]
    assert groups == sorted(groups)
    assert HE.work_items(0, L, F) == []


def _direct_sectors(pts, meta, F, mapping):
    """Per level, distinct (warp, sector) pairs of the corner gathers,
    counted point by point in plain Python."""
    n, L = len(pts), len(meta)
    warp = {}
    if mapping == "point":
        for t in range(n * L):
            warp[t // L, t % L] = t // 32
    else:
        items = HE.work_items(n, L, F)
        for i in range(n * len(items)):
            g, p = divmod(i, n)
            for l in range(items[g][1], items[g][1] + items[g][2]):
                warp[p, l] = i * HE.LANES_PER_POINT // 32
    out = []
    for l, (res, dense, rows) in enumerate(meta):
        pairs = set()
        for p, (x, y, z) in enumerate(pts):
            b = [min(max(int(np.floor(np.float32(c) * np.float32(res))), 0),
                     res - 1) for c in (x, y, z)]
            for c in range(8):
                cx, cy, cz = (b[0] + ((c >> 2) & 1), b[1] + ((c >> 1) & 1),
                              b[2] + (c & 1))
                if dense:
                    row = cx + (res + 1) * (cy + (res + 1) * cz)
                else:
                    h = (cx ^ (cy * 2654435761) ^ (cz * 805459861)) & 0xFFFFFFFF
                    row = h % rows
                pairs.add((warp[p, l], row * F * 4 // 32))
        out.append(len(pairs))
    return out


def _ray_points(bundle, rays, seed=0):
    rng = np.random.default_rng(seed)
    o = torch.from_numpy(rng.uniform(0.2, 0.8, (rays, 3)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(rays, 3)).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    pts, _, _ = scene.sample_points(o, d, bundle.asdr.ns_full)
    return pts.reshape(-1, 3)


@pytest.mark.parametrize("mapping,lanes", [("level", 1), ("level", 2),
                                           ("point", 2)])
@pytest.mark.parametrize("F", [1, 2, 3])
def test_warp_sectors_match_a_direct_count(mapping, lanes, F, monkeypatch):
    """At the small config, on ray-ordered samples (5 rays x 64, with
    points outside the cube), in chunks of 64 points (off the groups'
    warp bounds), against a count pair by pair; the kernel's warps of 16
    points (2 lanes a point) and warps of 32."""
    monkeypatch.setattr(HE, "LANES_PER_POINT", lanes)
    bundle = ingp_asdr.SMOKE
    pts = _ray_points(bundle, 5)
    meta = HE.grid_meta(bundle.model.grid)
    got = HE.warp_sectors(pts, meta, F, mapping, chunk=64)
    want = _direct_sectors(pts.numpy(), meta.tolist(), F, mapping)
    assert got.tolist() == want


def test_level_mapping_touches_fewer_sectors_at_the_coarse_levels():
    """Ray-ordered samples: a warp's consecutive points at one level share
    the coarse levels' sectors, where 2 points x L levels a warp cannot."""
    bundle = ingp_asdr.SMOKE
    pts = _ray_points(bundle, 8, seed=1)
    meta = HE.grid_meta(bundle.model.grid)
    lvl = HE.warp_sectors(pts, meta, 2, "level")
    pnt = HE.warp_sectors(pts, meta, 2, "point")
    assert lvl[0] < pnt[0] / 2
    assert lvl.sum() < pnt.sum()


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_wrapper_cpu_path_matches_pallas_off_the_warp(n):
    """The wrapper's CPU path (the kernel's plain version) against the JAX
    Pallas kernel in interpret mode, at point counts off the warp and the
    Pallas tile, points partly outside the cube."""
    jcfg = JNGPConfig.small()
    g = jcfg.grid
    rng = np.random.default_rng(n)
    pts = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    tables = rng.uniform(-1, 1, (g.n_levels, g.table_size,
                                 g.feature_dim)).astype(np.float32)
    want = np.asarray(jops.hash_encode(jnp.asarray(pts), jnp.asarray(tables),
                                       g))
    tcfg = ingp_asdr.SMOKE.model.grid
    HE.hash_encode.launches = 0
    got = HE.hash_encode(torch.from_numpy(pts), HE.grid_meta(tcfg),
                         torch.from_numpy(tables))
    assert HE.hash_encode.launches == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
