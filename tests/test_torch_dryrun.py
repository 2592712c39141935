"""Port parity: ``repro_torch.launch.dryrun``, ``launch/asdr_steps.py``
and ``launch/render_serve.py``'s pooled march cell against the
reference's ``repro.launch`` counterparts.

Every LM cell's record on the single- and multi-pod meshes keeps the
reference's keys; its ``analytic`` block equals the reference's
``analytic`` functions' values and its per-device argument (and, for
train, output) bytes equal the sum over the reference's own argument
trees of ``NamedSharding(AbstractMesh(...), spec).shard_shape`` (the
shard rounded up where the division is uneven, as XLA pads it) times the
item size.  ``main --all --mesh both`` writes a record or a skip record
per cell and no error file.  The ingp-asdr builders' ``extra`` dicts,
argument shapes and specs equal the reference's, built on an
``AbstractMesh`` (building a ``jax.jit`` compiles nothing), the pooled
march equals ``_march_block`` block by block, and the NGP train step
equals the reference's jitted step on a one-device mesh.  ``card_cell``
runs a train, a decode and the ingp-asdr cells on the CPU at ``SMOKE``.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would change every later JAX test in the process, so its
``LONG_OK``, ``cell_is_skipped`` and ``microbatches_for`` are read in one
subprocess that prints JSON."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
from repro.launch import analytic as janalytic
from repro.launch import asdr_steps as jsteps
from repro.launch import render_serve as jrs
from repro.models import lm as jlm
from repro.models.config import SHAPES as JSHAPES
from repro.sharding import rules as jrules
from repro.train.step import TrainConfig, make_train_step
from repro_torch import optim, prng
from repro_torch import params as tparams
from repro_torch.configs import ingp_asdr
from repro_torch.core import model as tmodel
from repro_torch.core import pipeline, scene
from repro_torch.launch import asdr_steps, dryrun
from repro_torch.launch import render_serve as trs
from repro_torch.sharding import rules as trules
from test_torch_lm_train import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jconfigs.list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "card": ((1, 1), ("data", "model"))}
# the reference's run_cell record: its keys beside the builders' extra
RECORD_KEYS = {"arch", "shape", "mesh", "n_chips", "lower_s", "compile_s",
               "memory", "cost_raw", "cost_scan_corrected", "analytic",
               "collectives", "roofline", "roofline_hlo",
               "model_flops_per_chip", "useful_flops_ratio"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
ASDR_KEYS = {"arch", "shape", "mesh", "n_chips", "lower_s", "compile_s",
             "memory", "cost_scan_corrected", "collectives", "roofline",
             "useful_flops_ratio"}

REFERENCE_LOGIC = """
import json
from repro.launch import dryrun as D
from repro.models.config import SHAPES
class Mesh:
    def __init__(self, shape):
        self.shape = shape
meshes = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "card": {"data": 1, "model": 1}}
archs = %r + ["ingp-asdr"]
print(json.dumps({
    "LONG_OK": sorted(D.LONG_OK),
    "skipped": {a + "|" + s: D.cell_is_skipped(a, s) for a in archs
                for s in list(SHAPES) + ["asdr_render"]},
    "microbatches": {s + "|" + m: D.microbatches_for(SHAPES[s], Mesh(v))
                     for s in SHAPES for m, v in meshes.items()},
}))
""" % (ARCHS,)


@pytest.fixture(scope="module")
def reference_logic():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_LOGIC], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_logic_equals_the_reference(reference_logic):
    assert sorted(dryrun.LONG_OK) == reference_logic["LONG_OK"]
    for key, skipped in reference_logic["skipped"].items():
        assert dryrun.cell_is_skipped(*key.split("|")) == skipped, key
    for key, mb in reference_logic["microbatches"].items():
        shape, mesh = key.split("|")
        assert dryrun.microbatches_for(dryrun.SHAPES[shape],
                                       dryrun.make_mesh(mesh)) == mb, key


_REFERENCE = {}


def _reference_trees(arch):
    """The reference API's abstract (values, axes), built once per arch."""
    if arch not in _REFERENCE:
        api = jlm.build(jconfigs.get(arch))
        _REFERENCE[arch] = (api, *api.abstract())
    return _REFERENCE[arch]


def _bf16(tree):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(
        s.shape, jnp.bfloat16 if jnp.issubdtype(s.dtype, jnp.floating)
        else s.dtype), tree)


def _bytes(values, specs, amesh):
    """Per-device bytes of ``values`` laid out by the jax spec tree
    ``specs``: AbstractMesh's shard shape, rounded up where uneven."""
    total = []

    def leaf(spec, v):
        try:
            shape = NamedSharding(amesh, spec).shard_shape(tuple(v.shape))
        except ValueError:       # uneven: XLA pads the last shard
            shape = tuple(-(-d // int(np.prod([amesh.shape[a] for a in (
                (e,) if isinstance(e, str) else (e or ()))])))
                for d, e in zip(v.shape, tuple(spec) + (None,) * len(
                    v.shape)))
        total.append(int(np.prod(shape)) * np.dtype(v.dtype).itemsize)

    jax.tree.map(leaf, specs, values, is_leaf=lambda x: isinstance(x, JP))
    return sum(total)


def _expected_memory(arch, shape_name, mesh_kind, microbatches):
    """The reference's argument (and train output) trees and specs, as its
    ``build_*_cell`` lays them, summed per device."""
    sizes, names = MESHES[mesh_kind]
    amesh = AbstractMesh(sizes, names)
    api, vals, axes = _reference_trees(arch)
    shape = JSHAPES[shape_name]
    dp = amesh.shape.get("data", 1) * amesh.shape.get("pod", 1)

    def specs(tree, rules):
        return jax.tree.map(lambda a: jrules.resolve_spec(a, rules, amesh),
                            tree, is_leaf=jrules.is_axes_leaf)

    scalar = jax.ShapeDtypeStruct((), jnp.int32)
    if shape.kind == "train":
        rules = jrules.TRAIN_RULES
        _, opt_init = make_train_step(api.loss_fn,
                                      TrainConfig(microbatches=microbatches),
                                      rules, None)
        opt = jax.eval_shape(opt_init, vals)
        p_sh = specs(axes, rules)
        opt_sh = {"m": p_sh, "v": p_sh, "count": JP()}
        batch = api.input_specs(shape)
        b_sh = {k: jrules.resolve_spec(api.input_axes()[k], rules, amesh)
                for k in batch}
        args = _bytes((vals, opt, batch, scalar),
                      (p_sh, opt_sh, b_sh, JP()), amesh)
        outs = _bytes((vals, opt), (p_sh, opt_sh), amesh) + 3 * 4
        return args, outs
    if shape.kind == "prefill":
        rules = (jrules.SERVE_RULES if shape.global_batch >= dp
                 else jrules.LONG_CONTEXT_SERVE_RULES)
        batch = api.input_specs(shape)
        b_sh = {k: jrules.resolve_spec(api.input_axes()[k], rules, amesh)
                for k in batch}
        return _bytes((_bf16(vals), batch), (specs(axes, rules), b_sh),
                      amesh), None
    B, S = shape.global_batch, shape.seq_len
    rules = (jrules.LONG_CONTEXT_SERVE_RULES if B < dp
             else jrules.SERVE_RULES)
    caches = api.decode_cache_specs(B, S)
    c_sh = specs(api.decode_cache_axes(B, S), rules)
    tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    tok_sh = jrules.resolve_spec(("batch", None), rules, amesh)
    return _bytes((_bf16(vals), caches, tok, scalar),
                  (specs(axes, rules), c_sh, tok_sh, JP()), amesh), None


_APIS = {}


def _record_api(arch):
    """``dryrun.record_api(arch)``, built once per arch."""
    if arch not in _APIS:
        _APIS[arch] = dryrun.record_api(arch)
    return _APIS[arch]


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_records_equal_the_reference(arch, shape, reference_logic):
    if reference_logic["skipped"][f"{arch}|{shape}"]:
        assert dryrun.cell_is_skipped(arch, shape)
        return
    api = _record_api(arch)
    jc, js = jconfigs.get(arch), JSHAPES[shape]
    for mesh in ("single", "multi"):
        rec = dryrun.run_cell(arch, shape, mesh, api=api)
        mb = (reference_logic["microbatches"][f"{shape}|{mesh}"]
              if js.kind == "train" else 1)
        assert RECORD_KEYS <= set(rec) and set(rec["memory"]) == MEMORY_KEYS
        assert rec["n_chips"] == int(np.prod(MESHES[mesh][0]))
        assert rec["analytic"] == {**janalytic.cell_flops(jc, js),
                                   **janalytic.cell_hbm_bytes(jc, js, mb)}
        args, outs = _expected_memory(arch, shape, mesh, mb)
        assert rec["memory"]["argument_bytes"] == args
        assert rec["memory"]["output_bytes"] == outs
        layers = jc.n_layers + getattr(jc, "encoder_layers", 0)
        if js.kind == "train":
            assert (rec["microbatches"], rec["scan_multiplier"]) == (
                mb, layers * mb)
        else:
            assert rec["scan_multiplier"] == (
                layers if js.kind == "prefill" else 1)
        assert sorted(rec["not_available"]) == sorted(
            [k for k, v in rec.items() if v is None]
            + [f"memory.{k}" for k, v in rec["memory"].items() if v is None])
        assert set(rec["not_available_reason"]) == set(rec["not_available"])


def test_main_writes_every_cell(tmp_path):
    dryrun.main(["--all", "--mesh", "both", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert not [f for f in files if f.endswith(".error.json")]
    assert len(files) == (len(ARCHS) * len(JSHAPES) + 3) * 2
    skips = 0
    for p in tmp_path.iterdir():
        rec = json.loads(p.read_text())
        if rec.get("skipped"):
            skips += 1
            assert rec["shape"] == "long_500k"
            continue
        keys = ASDR_KEYS if rec["arch"] == "ingp-asdr" else RECORD_KEYS
        assert keys <= set(rec) and rec["variant"] == "baseline"
        assert "not_available" in rec and "measured" not in rec
    assert skips == 2 * (len(ARCHS) - len(dryrun.LONG_OK))
    dryrun.main(["--arch", "hymba-1.5b", "--shape", "train_4k",
                 "--out", str(tmp_path)])           # done: skipped
    assert len(list(tmp_path.iterdir())) == len(files)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dryrun.main(["--all", "--mesh", "card", "--out", str(tmp_path)])


def _jax_leaves(tree):
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in optim.tree_leaves(tree)]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_asdr_builders_equal_the_reference(mesh_kind):
    sizes, names = MESHES[mesh_kind]
    amesh = AbstractMesh(sizes, names)
    tmesh = dryrun.make_mesh(mesh_kind)
    jb, tb = jconfigs.get("ingp-asdr"), ingp_asdr.CONFIG
    builders = [
        (lambda m: jsteps.build_render_cell(jb, m),
         lambda m: asdr_steps.build_render_cell(tb, m)),
        (lambda m: jsteps.build_render_cell(jb, m, variant="opt"),
         lambda m: asdr_steps.build_render_cell(tb, m, variant="opt")),
        (lambda m: jsteps.build_train_cell_ngp(jb, m),
         lambda m: asdr_steps.build_train_cell_ngp(tb, m)),
        (lambda m: jrs.build_pooled_march_cell(jb, m),
         lambda m: trs.build_pooled_march_cell(tb, m)),
    ]
    for jbuild, tbuild in builders:
        _, jargs, jextra = jbuild(amesh)
        step, targs, textra = tbuild(tmesh)
        assert textra == jextra
        assert _torch_leaves(targs) == _jax_leaves(jargs)
    for shard in (True, False):
        want = jax.tree.map(lambda s: tuple(s.spec), jsteps.param_shardings(
            jb.model, amesh, shard), is_leaf=lambda x: hasattr(x, "spec"))
        got = []
        trules.tree_map(got.append, asdr_steps.param_shardings(
            tb.model, tmesh, shard), is_leaf=lambda x: isinstance(
                x, trules.PartitionSpec))
        assert jax.tree.leaves(want, is_leaf=lambda x: isinstance(
            x, tuple)) == got
    assert asdr_steps._batch_spec(tmesh) == jsteps._batch_spec(amesh)


def _smoke_field(seed=3):
    cfg = ingp_asdr.SMOKE.model
    return tparams.from_jax_params(tparams.random_params(cfg, seed, 30.0),
                                   cfg, device="cpu")


def test_pooled_march_equals_march_block():
    """The pooled cell's step on 4 blocks of 64 of a SMOKE frame (the CPU:
    the plain field) against ``_march_block`` on each block alone."""
    bundle = ingp_asdr.SMOKE
    field = _smoke_field()
    step, _, extra = trs.build_pooled_march_cell(bundle, dryrun.make_mesh(
        "card"), pool_blocks=4)
    assert extra["pool_blocks"] == 4
    cam = scene.look_at_camera(16, 16, theta=0.9, phi=0.55)
    o, d = scene.camera_rays(cam, device="cpu")
    o, d = o.reshape(4, 64, 3), d.reshape(4, 64, 3)
    budgets = torch.tensor([8, 64, 16, 32], dtype=torch.int32)
    got = step(field.params(), o, d, budgets)
    acfg = dataclasses.replace(bundle.asdr,
                               block_size=asdr_steps.RENDER_BLOCK)
    fns = tmodel.field_fns(field)
    for i in range(4):
        want = pipeline._march_block(fns, acfg, o[i:i + 1], d[i:i + 1],
                                     budgets[i:i + 1])
        for g, w in zip(got, want):
            assert torch.equal(g[i:i + 1], w)
    assert bool((got[3] >= 1).all()) and int(got[3].max()) > 1


def test_asdr_steps_run_on_the_cpu(monkeypatch):
    """The render step is ``render_adaptive`` on the plain field (blocks
    cut to 64 rays); the train step lowers the loss and moves every param;
    the pooled blocks are the frame's sorted blocks, spread over its
    budgets."""
    monkeypatch.setattr(asdr_steps, "RENDER_BLOCK", 64)
    bundle = ingp_asdr.SMOKE
    field = _smoke_field()
    cam = scene.look_at_camera(16, 16, theta=0.9, phi=0.55)
    fns = tmodel.field_fns(field)
    acfg = dataclasses.replace(bundle.asdr, block_size=64)
    o, d, counts = asdr_steps.render_inputs(fns, bundle, cam, device="cpu")
    assert o.shape == (256, 3)
    step, _, extra = asdr_steps.build_render_cell(bundle, dryrun.make_mesh(
        "card"))
    assert extra["block"] == 64
    rgb, acc, stats = step(field.params(), o, d, counts)
    want = pipeline.render_adaptive(fns, acfg, o, d, counts)
    assert torch.equal(rgb, want[0]) and torch.equal(acc, want[1])
    assert torch.equal(stats["chunks_per_block"],
                       want[2]["chunks_per_block"])

    po, pd, pb = trs.pooled_blocks(bundle, o, d, counts, pool_blocks=3)
    assert po.shape == (3, 64, 3)
    assert pb.tolist() == sorted(pb.tolist())

    step, args, _ = asdr_steps.build_train_cell_ngp(bundle, dryrun.make_mesh(
        "card"))
    params = tmodel.init_ngp(bundle.model, prng.PRNGKey(0), device="cpu")
    params["grid"] = params["grid"] * 3e4
    opt = optim.adamw_init(params, asdr_steps.opt_config())
    rng = np.random.default_rng(0)
    rays = [torch.from_numpy(rng.uniform(0, 1, (16, 3)).astype(np.float32))
            for _ in range(3)]
    rays[1] = torch.nn.functional.normalize(rays[1] - 0.5, dim=-1)
    new, new_opt, loss = step(params, opt, *rays, torch.tensor(5e-3))
    assert torch.isfinite(loss) and int(new_opt["count"]) == 1
    for a, b in zip(optim.tree_leaves(params), optim.tree_leaves(new)):
        assert a.shape == b.shape and not torch.equal(a, b)
    assert [t.shape for t in optim.tree_leaves(step.outs)] == [
        t.shape for t in optim.tree_leaves((new, new_opt, loss))]


def test_train_step_equals_the_reference():
    """The NGP train cell's step at SMOKE on 16 rays against the
    reference's jitted ``build_train_cell_ngp`` step on a one-device mesh,
    from the same params, rays and lr (not the config's): the loss and the
    moments at rtol 1e-4 / atol 1e-5, the count exact, the new params at
    rtol 1e-4 / atol 1e-5 wherever the gradient is above rounding noise.

    Adam's first step moves a param by lr * m / (|m| + eps); with eps 1e-15
    a gradient at rounding noise (|m| ~1e-10 or ~1e-27 against a largest
    ~1e-2) moves its param a whole lr on one side and not on the other.
    There the params are held to differ by at most that step."""
    from jax.sharding import Mesh

    from repro.optim import adamw as jadamw

    cfg, lr = ingp_asdr.SMOKE.model, 2e-3
    tree = tparams.random_params(cfg, 5, 10.0)
    # MLP weights x 3: the gradients' global norm is ~2, so the clip at
    # 1.0 halves them
    tree["mlps"] = {k: [3.0 * w for w in v] for k, v in tree["mlps"].items()}
    rng = np.random.default_rng(5)
    o = rng.uniform(0.0, 1.0, (16, 3)).astype(np.float32)
    d = rng.uniform(-1.0, 1.0, (16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = rng.uniform(0.0, 1.0, (16, 3)).astype(np.float32)

    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstep, _, _ = jsteps.build_train_cell_ngp(jconfigs.get_smoke("ingp-asdr"),
                                              jmesh)
    jparams = jax.tree.map(jnp.asarray, tree)
    jopt = jadamw.adamw_init(jparams, jadamw.AdamWConfig(
        lr=5e-3, b2=0.99, eps=1e-15))
    jp, js, jloss = jstep(jparams, jopt, o, d, ref, jnp.float32(lr))

    step, _, _ = asdr_steps.build_train_cell_ngp(ingp_asdr.SMOKE,
                                                 dryrun.make_mesh("card"))
    params = tparams.from_jax_params(tree, cfg, device="cpu").params()
    opt = optim.adamw_init(params, asdr_steps.opt_config())
    tp, ts, tloss = step(params, opt, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(ref), torch.tensor(lr))

    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert int(ts["count"]) == int(js["count"]) == 1
    leaves = [(optim.tree_leaves(got), jax.tree.leaves(want))
              for got, want in ((tp, jp), (ts["m"], js["m"]),
                                (ts["v"], js["v"]))]
    assert all(len(g) == len(w) == len(leaves[0][0]) for g, w in leaves)
    for g, w in leaves[1:]:
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    for a, b, m in zip(*leaves[0], leaves[1][1]):
        a, b, m = a.numpy(), np.asarray(b), np.abs(np.asarray(m))
        sure = m > 1e-6 * m.max()
        np.testing.assert_allclose(a[sure], b[sure], rtol=1e-4, atol=1e-5)
        assert np.abs(a - b).max(initial=0.0) <= lr * (1 + 1e-4)


@pytest.mark.parametrize("arch, shape", [
    ("hymba-1.5b", "train_4k"), ("hymba-1.5b", "long_500k"),
    ("ingp-asdr", "asdr_render"), ("ingp-asdr", "asdr_train")])
def test_card_cell_runs_on_the_cpu(arch, shape, monkeypatch):
    """``card_cell`` on the CPU at SMOKE (the configs and the cells' sizes
    cut): a train, a decode and the two ingp-asdr cells are measured from
    inputs made from the seed; every output finite, no kernel launched."""
    from repro_torch import configs as tconfigs
    from repro_torch.models.config import ShapeCell

    monkeypatch.setattr(dryrun.configs, "get", tconfigs.get_smoke)
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeCell("train_4k", 16, 2, "train"))
    monkeypatch.setitem(dryrun.SHAPES, "long_500k",
                        ShapeCell("long_500k", 64, 1, "decode"))
    monkeypatch.setattr(asdr_steps, "RENDER_HW", (16, 16))
    monkeypatch.setattr(asdr_steps, "RENDER_BLOCK", 64)
    monkeypatch.setattr(asdr_steps, "TRAIN_RAYS", 16)
    rec, out = dryrun.card_cell(arch, shape, seed=3, device="cpu")
    m = rec["measured"]
    assert m is not None and m["finite"] and m["launches"] == {}
    assert m["peak_bytes"] is None and m["device"] == "cpu"
    assert m["argument_bytes"] > 0 and len(m["ms_runs"]) == dryrun.TIMED_RUNS
    assert rec["reckoned_bytes"] <= dryrun.CARD_BYTES
    assert "measured" not in rec["not_available"]
    if arch == "ingp-asdr":
        assert m["roofline_share"] is None
    else:
        assert m["roofline_share"] > 0 and rec["mesh"] == "card"
    if shape == "asdr_render":
        assert out[0].shape == (256, 3)
    if shape == "asdr_train":
        assert int(out[1]["count"]) == 1 and torch.isfinite(out[2])


def test_reckoning():
    """asdr_train's 2^18 x 128 samples do not fit one card; the pooled
    march and one row of hymba's prefill_32k do; no prefill_32k cell
    fits whole."""
    b = ingp_asdr.CONFIG
    rec = {"arch": "ingp-asdr", "shape": "asdr_train", "rays": 1 << 18,
           "memory": {"argument_bytes": 0}}
    assert dryrun.reckon_bytes(rec, b) > dryrun.CARD_BYTES
    rec = dict(rec, shape="render_serve", rays_per_call=1 << 18, block=4096)
    assert dryrun.reckon_bytes(rec, b) < dryrun.CARD_BYTES
    for arch in ARCHS:
        full = dryrun.lm_record(arch, dryrun.SHAPES["prefill_32k"], "card",
                                api=_record_api(arch))[0]
        assert dryrun.reckon_bytes(full) > dryrun.CARD_BYTES
    one = dryrun.lm_record("hymba-1.5b", dataclasses.replace(
        dryrun.SHAPES["prefill_32k"], global_batch=1), "card",
        api=_record_api("hymba-1.5b"))[0]
    assert dryrun.reckon_bytes(one) < dryrun.CARD_BYTES


@pytest.mark.parametrize("arch, shape", [
    ("gemma2-27b", "prefill_32k"), ("hymba-1.5b", "decode_32k"),
    ("hymba-1.5b", "train_4k")])
def test_reckoning_counts_float32_logits(arch, shape, monkeypatch):
    """At ``SMOKE``, a served LM cell's reckoning counts its logits at
    B * S * padded_vocab * 4 bytes (the float32 of the port's
    ``unembed``; S is 1 for decode), a train cell's as the analytic model
    does; the record's ``analytic`` block stays the reference's
    ``cell_hbm_bytes``, which counts a served cell's logits at 2 bytes."""
    from repro_torch import configs as tconfigs
    from repro_torch.models.config import ShapeCell

    monkeypatch.setattr(dryrun.configs, "get", tconfigs.get_smoke)
    kind = dryrun.SHAPES[shape].kind
    cell = ShapeCell(shape, 16, 2, kind)
    monkeypatch.setitem(dryrun.SHAPES, shape, cell)
    rec = dryrun.lm_record(arch, cell, "card")[0]
    jc = jconfigs.get_smoke(arch)
    an = janalytic.cell_hbm_bytes(jc, JSHAPES[shape].__class__(
        shape, 16, 2, kind), rec.get("microbatches", 1))
    assert {k: rec["analytic"][k] for k in an} == an
    rows = cell.global_batch * (1 if kind == "decode" else cell.seq_len)
    logits = (rows * jc.padded_vocab * 4 if kind != "train"
              else an["logits_bytes"])
    if kind != "train":
        assert an["logits_bytes"] == rows * jc.padded_vocab * 2
    assert dryrun.reckon_bytes(rec) == float(
        rec["memory"]["argument_bytes"] + an["activation_bytes"] + logits
        + an["cache_bytes"])
