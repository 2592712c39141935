"""Port parity and properties: the radiance-first, double-buffered
admission (serve/admission.py).

A full radiance hit skips Phase I and still delivers the always-probe
frame bit for bit; frames and admission counters are equal across
prefetch depths 0/1/2 and equal to the JAX engine's; probes + skips ==
admissions; skips never age probe entries; zero-march frames report
their samples as reused; latency covers queue wait and admission.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.framecache import probe as fc_probe
from repro_torch.framecache import radiance as fc_radiance
from repro_torch.serve import render_engine as tre
from test_torch_render_serve import (SIZE, assert_parity, field_pairs,
                                     requests, run_both, run_port)

R = SIZE * SIZE
REUSE = dict(slots=2, blocks_per_batch=4, reuse=dict(refresh_every=0),
             radiance=dict(refresh_every=0))


def port_engine(rcfg):
    from test_torch_render_serve import acfgs
    return tre.RenderServingEngine({"mic": field_pairs()["mic"][1]},
                                   acfgs()[1], rcfg, device="cpu")


def reuse_config(prefetch=0, probe_refresh=0, radiance_refresh=0, slots=2):
    return tre.RenderServeConfig(
        slots=slots, blocks_per_batch=4,
        reuse=fc_probe.ProbeReuseConfig(refresh_every=probe_refresh),
        radiance=fc_radiance.RadianceReuseConfig(
            refresh_every=radiance_refresh),
        prefetch=prefetch)


def same_pose(n):
    return requests([(i, "mic", 0.7, 0.5) for i in range(n)])[1]


def test_full_hit_skips_probe_bit_identity():
    """A replayed pose is a full radiance hit: it skips Phase I entirely
    (zero probe samples) yet delivers the always-probe engine's frame
    bit-exactly."""
    eng = port_engine(reuse_config(slots=1))
    done = {r.rid: r for r in eng.render(same_pose(3))}
    always = port_engine(tre.RenderServeConfig(
        slots=2, blocks_per_batch=4, reuse=None, radiance=None))
    ref = always.render(same_pose(1))[0]
    assert not done[0].stats["probe_skipped"]
    for rid in (1, 2):
        st = done[rid].stats
        assert st["probe_skipped"] and not st["probe_reused"]
        assert st["probe_samples"] == 0 and st["rays_marched"] == 0
        np.testing.assert_array_equal(done[rid].image, ref.image)
    st = eng.engine_stats()
    assert st["probe_skips"] == 2 and st["full_radiance_hits"] == 2
    cache = eng.probe_caches["mic"]
    assert cache.skips == 2 and cache.hits == 0 and cache.misses == 1


@pytest.mark.parametrize("prefetch", [0, 2])
def test_counter_invariant_probes_plus_skips_equal_admissions(prefetch):
    """Every admission probed (miss/refresh), reused maps (hit) or skipped
    Phase I behind a full warp hit — the three ledgers sum to admissions
    exactly, as the reference's do."""
    spec = [(i, "mic", 0.7 + 0.05 * (i % 3), 0.5) for i in range(7)]
    done_j, done_t, st_j, st = run_both(spec, prefetch=prefetch,
                                        radiance=dict(refresh_every=0),
                                        reuse=dict(refresh_every=0), slots=2,
                                        blocks_per_batch=4)
    assert_parity(done_j, done_t, st_j, st)
    assert (st["probe_hits"] + st["probe_misses"] + st["probe_skips"]
            == st["admissions"] == len(spec))


def test_determinism_across_prefetch_depths():
    """Prefetch only moves Stage-A device work earlier: frames AND all
    admission counters are bit-identical at depths 0/1/2 — including
    requests whose radiance source finishes between their speculation and
    their admission (the revalidation path) — and so equal to the JAX
    engine's synchronous run."""
    spec = [(i, "mic", 0.7 + 0.05 * (i % 3), 0.5) for i in range(9)]
    done_j, done_t, st_j, st_t = run_both(spec, prefetch=0, **REUSE)
    assert_parity(done_j, done_t, st_j, st_t)
    runs = {0: ({r.rid: r for r in done_t}, st_t)}
    for prefetch in (1, 2):
        done, st = run_port(spec, prefetch=prefetch, **REUSE)
        runs[prefetch] = ({r.rid: r for r in done}, st)
    done0, st0 = runs[0]
    for prefetch in (1, 2):
        done_p, st_p = runs[prefetch]
        for rid in done0:
            np.testing.assert_array_equal(done0[rid].image, done_p[rid].image)
        for key in ("admissions", "probe_hits", "probe_misses", "probe_skips",
                    "full_radiance_hits", "rays_marched", "samples_processed",
                    "samples_reused", "probe_refreshes"):
            assert st0[key] == st_p[key], (key, st0[key], st_p[key])
    assert st0["misprepares"] == 0


def test_prefetch_speculation_is_used_on_fresh_trajectories():
    """On distinct fresh poses the speculated probes survive revalidation
    (fresh plans share the ("probe",) basis), not recomputed at
    admission."""
    eng = port_engine(tre.RenderServeConfig(
        slots=2, blocks_per_batch=4,
        reuse=fc_probe.ProbeReuseConfig(max_angle_deg=0.01,
                                        max_translation=1e-4),
        radiance=None, prefetch=2))
    done = eng.render(requests([(i, "mic", 0.6 + 0.1 * i, 0.5)
                                for i in range(6)])[1])
    assert len(done) == 6
    assert eng.engine_stats()["misprepares"] == 0


def test_no_probe_cache_does_not_fake_reuse_fraction():
    """Probe reuse off, radiance on: reused_probe_fraction reads 0.0, and
    full_radiance_hits still records the skips."""
    eng = port_engine(tre.RenderServeConfig(
        slots=1, blocks_per_batch=4, reuse=None,
        radiance=fc_radiance.RadianceReuseConfig(refresh_every=0)))
    done = {r.rid: r for r in eng.render(same_pose(3))}
    st = eng.engine_stats()
    assert st["probe_hits"] == st["probe_misses"] == st["probe_skips"] == 0
    assert st["reused_probe_fraction"] == 0.0
    assert st["full_radiance_hits"] == 2
    assert done[1].stats["probe_skipped"] and done[2].stats["probe_skipped"]


def test_probe_skips_do_not_age_entries_or_force_refreshes():
    """Full-radiance-hit frames leave refreshes and entry age untouched."""
    eng = port_engine(reuse_config(probe_refresh=2, slots=1))
    eng.render(same_pose(6))
    cache = eng.probe_caches["mic"]
    assert cache.misses == 1 and cache.skips == 5 and cache.hits == 0
    assert cache.refreshes == 0
    assert cache._entries[0].reuses_since_probe == 0


def test_zero_march_frames_report_samples_reused():
    """A full-radiance-hit frame spends nothing and reuses everything, and
    engine_stats aggregates the split."""
    eng = port_engine(reuse_config(slots=1))
    done = {r.rid: r for r in eng.render(same_pose(2))}
    st0, st1 = done[0].stats, done[1].stats
    assert st0["samples_reused"] == 0 and st0["samples_processed"] > 0
    assert st1["samples_processed"] == 0
    assert st1["samples_reused"] == R * 48
    agg = eng.engine_stats()
    assert agg["samples_processed"] == st0["samples_processed"]
    assert agg["samples_reused"] == st1["samples_reused"]


def test_latency_covers_queue_wait_and_admission():
    """latency_s runs from render() entry: with one slot, the second
    request's latency strictly contains the first's march."""
    eng = port_engine(tre.RenderServeConfig(
        slots=1, blocks_per_batch=4, reuse=None, radiance=None))
    eng.render(requests([(9, "mic", 0.9, 0.5)])[1])
    done = {r.rid: r for r in eng.render(
        requests([(0, "mic", 0.7, 0.5), (1, "mic", 0.8, 0.5)])[1])}
    assert done[1].latency_s > done[0].latency_s
    for r in done.values():
        assert r.latency_s >= r.stats["admission_s"] >= 0.0
        assert r.stats["admission_s"] >= r.stats["admit_stall_s"] >= 0.0


def test_request_class_budget_tier_matches_reference():
    """A request admitted at a degraded class tier (budgets scaled before
    pad/sort) renders and counts as the reference's does."""
    spec = [(i, "mic", 0.7 + 0.05 * i, 0.5) for i in range(3)]
    classes = {1: dict(name="half", tiers=(1.0, 0.5), tier=1),
               2: dict(name="quarter", tiers=(1.0, 0.5, 0.25), tier=2)}
    done_j, done_t, st_j, st_t = run_both(
        spec, classes=classes, reuse=None, slots=2, blocks_per_batch=4)
    assert_parity(done_j, done_t, st_j, st_t)
    by = {r.rid: r for r in done_t}
    assert by[2].stats["samples_processed"] < by[0].stats["samples_processed"]
    assert dataclasses.asdict(by[1].cls)["tier"] == 1
