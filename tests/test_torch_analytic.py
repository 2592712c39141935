"""Port parity: ``repro_torch.launch.analytic`` and ``launch/roofline.py``
against the reference's ``repro.launch.analytic`` and
``repro.launch.roofline``, exactly (``==``).

The analytic FLOP and byte models for all ten archs x the four shapes x
remat on and off x 1 and 8 microbatches, each layer window's attention
context, and ``model_flops``; ``roofline_terms`` with the port's
constants set to the reference's and on the H100's own; the HLO text
parser (``collective_bytes``, ``_shape_bytes``) on a hand-written module
with an ENTRY and a while body, all five collective kinds, ``-start`` /
``-done`` pairs, a tuple shape and an unknown dtype."""

import pytest

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import analytic as janalytic
from repro.launch import roofline as jroofline
from repro.models import config as jconfig
from repro_torch.launch import analytic as tanalytic
from repro_torch.launch import roofline as troofline
from repro_torch.models import config as tconfig
from test_torch_lm_train import one_torch_thread  # noqa: F401

ARCHS = jconfigs.list_archs()
SHAPES = list(jconfig.SHAPES)


def test_shapes_and_archs_match_the_reference():
    assert tconfigs.list_archs() == ARCHS
    assert list(tconfig.SHAPES) == SHAPES
    for name in SHAPES:
        j, t = jconfig.SHAPES[name], tconfig.SHAPES[name]
        assert (t.name, t.seq_len, t.global_batch, t.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_models_equal_the_reference(arch, shape):
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    js, ts = jconfig.SHAPES[shape], tconfig.SHAPES[shape]
    S, kind = js.seq_len, js.kind
    for w in sorted(set(jc.layer_kinds()) | {0, 1, S // 2, 2 * S}):
        assert tanalytic._attn_context(S, w, kind) == janalytic._attn_context(
            S, w, kind)
    assert tanalytic.layer_forward_flops(tc, S, kind) == (
        janalytic.layer_forward_flops(jc, S, kind))
    for remat in (True, False):
        assert tanalytic.cell_flops(tc, ts, remat) == janalytic.cell_flops(
            jc, js, remat)
    for mb in (1, 8):
        assert tanalytic.cell_hbm_bytes(tc, ts, mb) == (
            janalytic.cell_hbm_bytes(jc, js, mb))
    tokens = js.global_batch * (js.seq_len if kind != "decode" else 1)
    assert troofline.model_flops(tc, tokens, kind) == jroofline.model_flops(
        jc, tokens, kind)


ROOFLINE_CASES = [(0.0, 0.0, 0.0), (1e15, 1e9, 0.0), (1e9, 1e13, 1e6),
                  (1e9, 1e6, 1e12), (3.3e17, 2.2e12, 4.4e10)]


def test_roofline_terms_on_the_reference_constants(monkeypatch):
    monkeypatch.setattr(troofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(troofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(troofline, "LINK_BW", jroofline.ICI_BW)
    for case in ROOFLINE_CASES:
        assert troofline.roofline_terms(*case) == (
            jroofline.roofline_terms(*case))


def test_roofline_terms_on_the_h100():
    """One H100 SXM at 700 W (NVIDIA's data sheet): dense bf16, HBM3,
    NVLink each way; no TPU figure is left."""
    assert (troofline.PEAK_FLOPS, troofline.HBM_BW, troofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert not hasattr(troofline, "ICI_BW")
    for flops, nbytes, coll in ROOFLINE_CASES:
        t = troofline.roofline_terms(flops, nbytes, coll)
        assert t["compute_s"] == flops / 989e12
        assert t["memory_s"] == nbytes / 3.35e12
        assert t["collective_s"] == coll / 450e9
        want = max(("compute_s", "memory_s", "collective_s"), key=t.get)
        assert t["bottleneck"] == want.replace("_s", "")


HLO = """HloModule jit_step, entry_computation_layout={(f32[16,128]{1,0})->f32[]}

%body (p: (s32[], bf16[8,256])) -> (s32[], bf16[8,256]) {
  %p = (s32[], bf16[8,256]{1,0}) parameter(0)
  %ag = bf16[8,256]{1,0} all-gather(bf16[1,256]{1,0} %x), dimensions={0}
  %ars = f32[8,128]{1,0} all-reduce-start(f32[8,128]{1,0} %y), to_apply=%add
  %ard = f32[8,128]{1,0} all-reduce-done(f32[8,128]{1,0} %ars)
  %rs = f32[2,64]{1,0} reduce-scatter(f32[32,64]{1,0} %z), dimensions={0}
  %a2a = (bf16[4,32]{1,0}, bf16[4,32]{1,0}) all-to-all(bf16[4,32] %u, bf16[4,32] %w)
  %cp = u8[1024]{0} collective-permute(u8[1024]{0} %v), source_target_pairs={{0,1}}
  %odd = q7[64]{0} all-gather(q7[4]{0} %q), dimensions={0}
  %add.1 = f32[8,128]{1,0} add(f32[8,128] %ard, f32[8,128] %ard)
}

ENTRY %main (a: f32[16,128]) -> f32[] {
  %a = f32[16,128]{1,0} parameter(0)
  %cps = (f32[16,128]{1,0}, u32[]) collective-permute-start(f32[16,128]{1,0} %a)
  %cpd = f32[16,128]{1,0} collective-permute-done(%cps)
  %ar = f32[] all-reduce(f32[] %s), to_apply=%add
  %w = (s32[], bf16[8,256]) while(%init), condition=%cond, body=%body
  ROOT %r = f32[] add(f32[] %ar, f32[] %ar)
}
"""


@pytest.mark.parametrize("body_multiplier", [1, 7])
def test_collective_bytes_equal_the_reference(body_multiplier):
    got = troofline.collective_bytes(HLO, body_multiplier=body_multiplier)
    assert got == jroofline.collective_bytes(HLO,
                                             body_multiplier=body_multiplier)
    assert got["count"] == 8 and got["entry"] > 0 and got["body_raw"] > 0
    assert all(got[k] > 0 for k in troofline._COLLECTIVES)


def test_shape_bytes_equal_the_reference():
    assert troofline._DTYPE_BYTES == jroofline._DTYPE_BYTES
    assert troofline._COLLECTIVES == jroofline._COLLECTIVES
    for s in ("f32[16,128]", "bf16[8,256]{1,0}", "(f32[2], s8[3,3])",
              "pred[]", "q7[64]", "c128[2,2]", "f8e4m3fn[5]", "u4[7]",
              "(bf16[4,32]{1,0}, bf16[4,32]{1,0}, u32[])", ""):
        assert troofline._shape_bytes(s) == jroofline._shape_bytes(s)
