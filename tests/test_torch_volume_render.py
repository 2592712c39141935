"""Port parity: decoupled volume rendering (``ops.volume_render``, its CPU
path: the kernel's plain version) against the JAX ``ops.volume_render``
(Pallas in interpret mode) and its oracle ``ref.ref_volume_render``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import decouple, rendering
from repro_torch.kernels import ops as tops
from repro_torch.kernels import volume_render as tvr

RTOL, ATOL = 1e-4, 1e-5

# (R, S, group, valid): the reference's cases, an odd group whose last
# group is short, and the valid mask
CASES = {
    "4x32_g2": (4, 32, 2, False),
    "8x64_g1": (8, 64, 1, False),
    "5x50_g3": (5, 50, 3, False),
    "6x32_g2_valid": (6, 32, 2, True),
}


def _inputs(R, S, group, masked):
    rng = np.random.default_rng(R * S + group)
    A = -(-S // group)
    sig = (rng.uniform(size=(R, S)) * 8).astype(np.float32)
    anch = rng.uniform(size=(R, A, 3)).astype(np.float32)
    dl = np.full((R, S), 0.02, np.float32)
    valid = None
    if masked:
        valid = np.broadcast_to(np.arange(S) < S // 2, (R, S)).copy()
    return sig, anch, dl, valid


def _jax(fn, sig, anch, dl, group, valid, **kw):
    v = None if valid is None else jnp.asarray(valid)
    return fn(jnp.asarray(sig), jnp.asarray(anch), jnp.asarray(dl), group,
              valid=v, **kw)


def _torch(sig, anch, dl, group, valid, **kw):
    v = None if valid is None else torch.from_numpy(valid)
    return tops.volume_render(torch.from_numpy(sig), torch.from_numpy(anch),
                              torch.from_numpy(dl), group, valid=v, **kw)


@pytest.mark.parametrize("against", ["pallas", "oracle"])
@pytest.mark.parametrize("case", list(CASES))
def test_volume_render_matches_reference(case, against):
    R, S, group, masked = CASES[case]
    sig, anch, dl, valid = _inputs(R, S, group, masked)
    fn = jops.volume_render if against == "pallas" else jref.ref_volume_render
    rgb_j, acc_j = _jax(fn, sig, anch, dl, group, valid)
    rgb_t, acc_t = _torch(sig, anch, dl, group, valid)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL,
                               atol=ATOL)


def test_volume_render_black_background():
    sig, anch, dl, _ = _inputs(7, 40, 4, False)
    rgb_j, acc_j = _jax(jref.ref_volume_render, sig, anch, dl, 4, None,
                        white_background=False)
    rgb_t, acc_t = _torch(sig, anch, dl, 4, None, white_background=False)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL,
                               atol=ATOL)


def test_volume_render_plain_is_lerp_then_composite():
    """The plain version (the kernel's arithmetic, sample by sample) is the
    port's own interpolate-then-composite, within float32 rounding."""
    sig, anch, dl, _ = _inputs(9, 48, 2, False)
    s, a, d = map(torch.from_numpy, (sig, anch, dl))
    packed = tvr.volume_render_plain(s, d, a, 2)
    colors = decouple.interpolate_group_colors(a, 2, 48)
    rgb, acc, _ = rendering.composite(s, colors, d, white_background=False)
    assert packed.shape == (9, tvr.OUT_W)
    np.testing.assert_allclose(packed[:, 0].numpy(), acc.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(packed[:, 1:].numpy(), rgb.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_volume_render_keeps_the_prefix_behind_a_huge_sample():
    """One sample whose sigma*delta dwarfs the sum before it (trunc_exp
    lets sigma reach e^15): the transmittance of the samples before and
    after it still matches the log-space oracle.  Subtracting sd from an
    inclusive cumsum would lose the prefix to cancellation here."""
    R, S, group = 3, 32, 2
    sig, anch, dl, _ = _inputs(R, S, group, False)
    sig[:] = 2.0
    sig[:, 20] = np.float32(np.exp(15.0))
    rgb_j, acc_j = _jax(jref.ref_volume_render, sig, anch, dl, group, None)
    rgb_t, acc_t = _torch(sig, anch, dl, group, None)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=RTOL,
                               atol=ATOL)


# (S, A, group): the decoupled frame, ragged lengths, one anchor, groups
# larger than a chunk, and fewer anchors than groups
SMEM_CASES = [(192, 96, 2), (50, 1, 3), (50, 17, 3), (7, 3, 3), (64, 64, 1),
              (1000, 10, 100), (17, 9, 2), (33, 2, 40)]


@pytest.mark.parametrize("S,A,group", SMEM_CASES)
def test_volume_render_smem_counts_the_anchors_each_chunk_reads(S, A, group):
    """The kernel's shared memory against a direct count: for every chunk
    of CHUNK samples, the anchors its samples lerp between (lo and hi of
    each, clamped to A - 1) form one run, whose longest length sets a
    ray's anchor row; sigma and delta take a padded row each; two buffers
    and a table of RAYS lerp offsets per warp.  At most CHUNK + 1 anchors,
    whatever S and A."""
    most = 1
    for s0 in range(0, S, tvr.CHUNK):
        used = set()
        for j in range(s0, min(S, s0 + tvr.CHUNK)):
            used |= {min(j // group, A - 1), min(j // group + 1, A - 1)}
        assert used == set(range(min(used), max(used) + 1))
        most = max(most, len(used))
    assert tvr.anchors_per_chunk(S, A, group) == most <= tvr.CHUNK + 1
    # a run staged from the 16-B boundary below it spans up to 3 + 3 * most
    # floats, in an odd number of float4s
    arow = 4 * -(-(3 + 3 * most) // 4)
    arow += 4 * (arow // 4 % 2 == 0)
    assert tvr.anchor_row(most) == arow
    per_warp = 2 * tvr.RAYS * (2 * tvr.ROW_FLOATS + arow) + tvr.RAYS
    assert tvr.volume_render_smem_bytes(S, A, group) == 4 * tvr.WARPS * per_warp
    assert tvr.ROW_FLOATS % 4 == 0 and per_warp % 4 == 0     # 16-B rows
    assert tvr.volume_render_smem_bytes(S, A, group) <= \
        tvr.volume_render_smem_bytes(10 ** 6, 10 ** 6, 1)


def test_volume_render_plain_on_a_ragged_frame():
    """R off the warp's 32 rays, S off the chunk, group 3, one anchor:
    the plain version (what the kernel is held to bit for bit) against
    the JAX oracle."""
    rng = np.random.default_rng(21)
    R, S, group, A = 37, 23, 3, 1
    sig = (rng.uniform(size=(R, S)) * 8).astype(np.float32)
    anch = rng.uniform(size=(R, A, 3)).astype(np.float32)
    dl = rng.uniform(0.0, 0.05, size=(R, S)).astype(np.float32)
    packed = tvr.volume_render_plain(*map(torch.from_numpy, (sig, dl, anch)),
                                     group)
    colors = np.broadcast_to(anch, (R, S, 3))
    w = np.asarray(jref.ref_volume_render(
        jnp.asarray(sig), jnp.asarray(np.ascontiguousarray(anch)),
        jnp.asarray(dl), group, white_background=False)[1])
    np.testing.assert_allclose(packed[:, 0].numpy(), w, rtol=RTOL, atol=ATOL)
    acc = packed[:, 0].numpy()[:, None]
    np.testing.assert_allclose(packed[:, 1:].numpy(), acc * colors[:, 0],
                               rtol=RTOL, atol=ATOL)
