"""The dry-run (``repro.launch.dryrun``) reduced to one H100: one JSON
record per (arch x shape x mesh) cell.

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's memory and cost analyses.  The port has no compiler: a cell is
its step, its arguments on the meta device and the reference's shardings
as spec trees (``sharding.rules``) on a logical mesh (``launch/mesh.py``),
so nothing here needs ``XLA_FLAGS`` or a device.  Per cell the record
keeps the reference's keys:

  * memory.argument_bytes — per device, every argument leaf's shard shape
    (each dim over its mesh axes, rounded up, as XLA pads an uneven
    shard) times its item size; output_bytes where the reference fixes
    ``out_shardings`` (train), else null
  * analytic — ``launch/analytic.py``'s FLOPs and HBM bytes (the LM cells;
    the ingp-asdr cells have no FLOP model, so theirs are null)
  * roofline — the analytic per-chip FLOPs and bytes on the H100's peaks
    (``launch/roofline.py``), collectives 0 on a logical mesh
  * model_flops_per_chip, useful_flops_ratio — as in the reference
  * not_available — the keys left null (XLA's cost analysis, HLO
    collectives, lower/compile seconds, temps and peak), with the reason

``--mesh card`` is the one H100, a (1, 1) mesh: each cell that fits is also
run on the card, once warm and three times timed, from inputs made from
``--seed``; its record gets ``measured`` (median ms, peak and argument
bytes, kernel launches a call, the analytic bound's share of the time,
whether every output is finite).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card
"""
import argparse
import dataclasses
import functools
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .. import configs, optim, prng
from .. import params as params_lib
from ..core import model as model_lib
from ..core import scene
from ..device import resolve_device
from ..kernels import ops
from ..models import attention as attn_lib
from ..models import encdec, lm
from ..models import transformer as tfm
from ..models.config import SHAPES
from ..sharding import rules as rules_lib
from ..sharding.activation import activation_sharding
from ..sharding.rules import PartitionSpec
from ..train.step import TrainConfig, make_train_step
from . import analytic, asdr_steps
from . import mesh as mesh_lib
from . import render_serve as rs_mod
from . import roofline

# long_500k requires sub-quadratic attention: run for SSM/hybrid and the
# local+global alternating gemma family (O(seq) decode against a sharded
# cache, window-bounded local layers); skip for pure full-attention archs
# and whisper (decoder context is architecturally bounded).
LONG_OK = {"gemma2-27b", "gemma3-12b", "mamba2-780m", "hymba-1.5b"}
ASDR_SHAPES = ("asdr_render", "asdr_train", "render_serve")
LOGIT_BYTES = 4                 # float32 logits (models/transformer.unembed)
# what one card may hold of a cell's reckoned bytes (80 GB less headroom
# for the allocator and the CUDA context)
CARD_BYTES = 70e9
TIMED_RUNS = 3
NO_COMPILER = ("no XLA compiler in the port: its steps run eagerly, so "
               "there is no HLO, cost analysis, lowering, compile or buffer "
               "assignment to read")
NO_FLOP_MODEL = "no analytic FLOP model for the renderer (nor in the reference)"
# the reference's keys no port record can fill, and why
XLA_KEYS = ("cost_raw", "cost_scan_corrected", "roofline_hlo", "collectives",
            "lower_s", "compile_s")
REASONS = {
    **{k: NO_COMPILER for k in XLA_KEYS},
    "memory.temp_bytes": NO_COMPILER,
    "memory.peak_bytes": NO_COMPILER,
    "memory.output_bytes": ("the reference fixes out_shardings for train "
                            "cells only; elsewhere XLA lays the outputs out"),
    "analytic": NO_FLOP_MODEL,
    "roofline": NO_FLOP_MODEL,
}


def cell_is_skipped(arch: str, shape: str) -> bool:
    return shape == "long_500k" and arch not in LONG_OK


def make_mesh(kind: str) -> mesh_lib.LogicalMesh:
    if kind == "card":
        return mesh_lib.make_card_mesh()
    return mesh_lib.make_production_mesh(multi_pod=kind == "multi")


def _meta(shape=(), dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _bf16(tree):
    return rules_lib.tree_map(
        lambda t: _meta(t.shape, torch.bfloat16) if t.is_floating_point()
        else t, tree)


def microbatches_for(shape, mesh) -> int:
    """Bound per-microbatch rows-per-device to <=2 (activation/logit peaks)."""
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    rows = max(1, shape.global_batch // dp)
    return max(1, rows // 2)


def _specs(axes_tree, rules, mesh):
    return rules_lib.param_specs(axes_tree, rules, mesh)


def _layers(cfg) -> int:
    return cfg.n_layers + getattr(cfg, "encoder_layers", 0)


def build_train_cell(api, shape, mesh, variant="baseline"):
    rules = rules_lib.TRAIN_RULES
    vals, axes = api.abstract()
    mb = microbatches_for(shape, mesh)
    if variant == "opt":
        # §Perf C1+C2+C3: bf16 gathers, half the microbatches, grads
        # pinned to param shardings
        tcfg = TrainConfig(microbatches=max(1, mb // 2),
                           cast_params_bf16=True)
        step, opt_init = make_train_step(api.loss_fn, tcfg, rules, mesh,
                                         param_axes=axes)
    else:
        tcfg = TrainConfig(microbatches=mb)
        step, opt_init = make_train_step(api.loss_fn, tcfg, rules, mesh)
    opt_abs = opt_init(vals)

    p_sh = _specs(axes, rules, mesh)
    scalar = PartitionSpec()
    opt_sh = {"m": p_sh, "v": p_sh, "count": scalar}
    b_axes = api.input_axes()
    batch_specs = api.input_specs(shape)
    b_sh = {k: rules_lib.resolve_spec(b_axes[k], rules, mesh)
            for k in batch_specs}
    metrics = {k: _meta() for k in ("grad_norm", "loss", "lr")}
    cell = mesh_lib.Step(
        step, (p_sh, opt_sh, b_sh, scalar),
        out_specs=(p_sh, opt_sh, {k: scalar for k in metrics}),
        outs=(vals, opt_abs, metrics))
    args = (vals, opt_abs, batch_specs, _meta((), torch.int32))
    return cell, args, {
        "microbatches": tcfg.microbatches,
        # the reference's scan bodies are listed once in HLO:
        "scan_multiplier": _layers(api.cfg) * tcfg.microbatches,
    }


def build_prefill_cell(api, shape, mesh, variant="baseline"):
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    rules = (rules_lib.SERVE_RULES if shape.global_batch >= dp
             else rules_lib.LONG_CONTEXT_SERVE_RULES)
    vals, axes = api.abstract()
    vals = _bf16(vals)
    p_sh = _specs(axes, rules, mesh)
    b_axes = api.input_axes()
    batch_specs = api.input_specs(shape)
    b_sh = {k: rules_lib.resolve_spec(b_axes[k], rules, mesh)
            for k in batch_specs}

    def prefill(values, batch):
        with activation_sharding(rules, mesh):
            return api.prefill_fn(values, batch)

    return mesh_lib.Step(prefill, (p_sh, b_sh)), (vals, batch_specs), {
        "rules": "serve",
        "scan_multiplier": _layers(api.cfg),
    }


def build_decode_cell(api, shape, mesh, variant="baseline"):
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    long_ctx = shape.global_batch < dp
    rules = (rules_lib.LONG_CONTEXT_SERVE_RULES if long_ctx
             else rules_lib.SERVE_RULES)
    if variant == "opt" and not long_ctx:
        rules = rules_lib.DECODE_SP_RULES  # §Perf: cache seq over model
    vals, axes = api.abstract()
    vals = _bf16(vals)
    p_sh = _specs(axes, rules, mesh)
    scalar = PartitionSpec()

    B, S = shape.global_batch, shape.seq_len
    cache_specs = api.decode_cache_specs(B, S)
    c_sh = _specs(api.decode_cache_axes(B, S), rules, mesh)
    tok_sh = rules_lib.resolve_spec(("batch", None), rules, mesh)

    def decode(values, caches, token, pos):
        with activation_sharding(rules, mesh):
            return api.decode_fn(values, caches, token, pos)

    args = (vals, cache_specs, _meta((B, 1), torch.int32),
            _meta((), torch.int32))
    return mesh_lib.Step(decode, (p_sh, c_sh, tok_sh, scalar)), args, {
        "rules": "long_ctx" if long_ctx else "serve",
        "scan_multiplier": 1,  # decode unrolls layers in python
    }


BUILDERS = {"train": build_train_cell, "prefill": build_prefill_cell,
            "decode": build_decode_cell}


def _memory(step, args, mesh) -> dict:
    out = (mesh_lib.tree_bytes(step.outs, step.out_specs, mesh)
           if step.out_specs is not None else None)
    return {"argument_bytes": mesh_lib.tree_bytes(args, step.in_specs, mesh),
            "output_bytes": out, "temp_bytes": None, "peak_bytes": None}


def _finish(record: dict) -> dict:
    """The reference's keys the port cannot fill set to null, and
    ``not_available`` naming every null key, with ``not_available_reason``
    saying why."""
    for k in XLA_KEYS:
        record.setdefault(k, None)
    reasons = dict(REASONS, measured=record.get(
        "not_measured", "an analytic record: not run on the card"))
    nulls = [k for k, v in record.items() if v is None] + [
        f"memory.{k}" for k, v in record["memory"].items() if v is None]
    record["not_available"] = nulls
    record["not_available_reason"] = {k: reasons[k] for k in nulls}
    return record


def record_api(arch: str):
    """The arch's API for analytic records (on the CPU, never run), its
    ``abstract`` tree built once."""
    api = lm.build(configs.get(arch), device="cpu")
    return dataclasses.replace(api, abstract=functools.cache(api.abstract))


def lm_record(arch, shape, mesh_kind, variant="baseline", device="cpu",
              api=None):
    """(record, step, args, cfg): the LM cell's analytic record on the
    mesh ``mesh_kind``, and its step built on ``device`` (or from ``api``,
    e.g. ``record_api``'s)."""
    cfg = configs.get(arch)
    mesh = make_mesh(mesh_kind)
    if api is None:
        # training differentiates: on the card it takes the training route
        attend = attn_lib.attend_causal if shape.kind == "train" else None
        api = lm.build(cfg, attention=attend, device=device)
    step, args, extra = BUILDERS[shape.kind](api, shape, mesh,
                                             variant=variant)
    n_chips = mesh.size
    an_f = analytic.cell_flops(cfg, shape)
    an_b = analytic.cell_hbm_bytes(cfg, shape, extra.get("microbatches", 1))
    an_flops_chip = an_f["total_flops"] / n_chips
    an_bytes_chip = an_b["total_bytes"] / n_chips
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    mf_per_chip = roofline.model_flops(cfg, tokens, shape.kind) / n_chips
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "n_chips": n_chips,
        "memory": _memory(step, args, mesh),
        "analytic": {**an_f, **an_b},
        # analytic flops/bytes; a logical mesh moves no collective bytes
        "roofline": roofline.roofline_terms(an_flops_chip, an_bytes_chip,
                                            0.0),
        "model_flops_per_chip": mf_per_chip,
        "useful_flops_ratio": (mf_per_chip / an_flops_chip)
                              if an_flops_chip else 0.0,
        **extra,
    }
    return record, step, args, cfg


def asdr_record(shape_name, mesh_kind, variant="baseline", device="cpu"):
    """(record, step, args, bundle): an ingp-asdr cell's record."""
    bundle = configs.get("ingp-asdr")
    mesh = make_mesh(mesh_kind)
    if shape_name == "asdr_render":
        step, args, extra = asdr_steps.build_render_cell(bundle, mesh,
                                                         variant=variant)
    elif shape_name == "asdr_train":
        step, args, extra = asdr_steps.build_train_cell_ngp(bundle, mesh)
    elif shape_name == "render_serve":
        step, args, extra = rs_mod.build_pooled_march_cell(bundle, mesh)
    else:
        raise ValueError(shape_name)
    if shape_name == "render_serve":
        # the scene-space block tier's reuse numbers ride along in the
        # serving cell's record: a tiny concrete multi-client run
        extra = dict(extra, scenecache=rs_mod.scenecache_smoke(
            device=device))
    record = {
        "arch": "ingp-asdr", "shape": shape_name, "mesh": mesh_kind,
        "n_chips": mesh.size,
        "memory": _memory(step, args, mesh),
        # no analytic FLOP model for the renderer (nor in the reference)
        "analytic": None, "roofline": None,
        "useful_flops_ratio": 1.0,
        **extra,
    }
    return record, step, args, bundle


def reckon_bytes(record, bundle=None) -> float:
    """What one card must hold for the cell, by reckoning: its argument
    bytes plus, for an LM cell, the analytic activation, logits and cache
    terms (``cell_hbm_bytes``: traffic over all layers, so more than the
    live set) with the logits at float32, for an ingp-asdr cell
    ``asdr_steps.working_bytes``.  No bound: a cell may peak above it."""
    args = record["memory"]["argument_bytes"]
    if record["arch"] == "ingp-asdr":
        return float(args) + asdr_steps.working_bytes(
            bundle, record["shape"], record)
    an = record["analytic"]
    logits = an["logits_bytes"]
    if SHAPES[record["shape"]].kind != "train":
        # the analytic model counts a served cell's logits at bf16 (2 B);
        # the port's ``unembed`` keeps them float32
        logits *= LOGIT_BYTES / 2
    return float(args + an["activation_bytes"] + logits + an["cache_bytes"])


def _on(tree, dev):
    """Zeros of the meta tree ``tree`` on ``dev``."""
    return rules_lib.tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev), tree)


def lm_inputs(cfg, shape, step_args, seed: int, dev):
    """Concrete arguments for an LM cell on ``dev``: params from
    ``prng.PRNGKey(seed)`` (float32 for a train cell, else bf16), the
    batch from numpy ``default_rng(seed)``, caches zero, decode at the
    cache's last position."""
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    init = encdec.model_init if cfg.family == "encdec" else tfm.model_init
    values = init(prng.PRNGKey(seed), cfg, dtype, dev)[0]

    def batch():
        out = {}
        specs = step_args[1 if shape.kind == "prefill" else 2]
        for k, t in specs.items():
            if k == "tokens":
                out[k] = torch.from_numpy(rng.integers(
                    0, cfg.vocab, tuple(t.shape), dtype=np.int32)).to(dev)
            else:
                out[k] = torch.from_numpy(rng.standard_normal(
                    tuple(t.shape), dtype=np.float32)).to(dev, t.dtype)
        return out

    if shape.kind == "prefill":
        return values, batch()
    if shape.kind == "decode":
        token = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1),
                                              dtype=np.int32)).to(dev)
        return values, _on(step_args[1], dev), token, S - 1
    opt = _on(step_args[1], dev)
    return values, opt, batch(), 1


def asdr_inputs(bundle, shape_name, step_args, seed: int, dev):
    """Concrete arguments for an ingp-asdr cell on ``dev``.  The render
    cells: the main path's field (``params.random_params(seed,
    asdr_steps.RENDER_TABLE_SCALE)``) and its 800x800 frame at
    ``asdr_steps.RENDER_VIEW`` with its Phase I counts (the pooled march:
    ``render_serve.pooled_blocks`` of it).  The train cell: params from
    ``init_ngp(prng.PRNGKey(seed))``, rays and colours from numpy
    ``default_rng(seed)``."""
    if shape_name == "asdr_train":
        params = model_lib.init_ngp(bundle.model, prng.PRNGKey(seed),
                                    device=dev)
        rng = np.random.default_rng(seed)
        rays = [torch.from_numpy(rng.uniform(0.0, 1.0, tuple(t.shape))
                                 .astype(np.float32)).to(dev)
                for t in step_args[2:5]]
        rays[1] = torch.nn.functional.normalize(rays[1] - 0.5, dim=-1)
        opt = optim.adamw_init(params, asdr_steps.opt_config())
        return (params, opt, *rays, torch.tensor(5e-3, device=dev))
    field = params_lib.from_jax_params(params_lib.random_params(
        bundle.model, seed, asdr_steps.RENDER_TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(*asdr_steps.RENDER_HW, **asdr_steps.RENDER_VIEW)
    o, d, counts = asdr_steps.render_inputs(
        asdr_steps.field_fns(field.params(), bundle.model), bundle, cam,
        device=dev)
    if shape_name == "render_serve":
        return (field.params(), *rs_mod.pooled_blocks(bundle, o, d, counts))
    return field.params(), o, d, counts


def measure(step, args, dev, runs: int = TIMED_RUNS):
    """(last output, measured dict): ``step(*args)`` once warm, the kernel
    launches it adds to ``ops.launch_counts()``, then ``runs`` times on
    the host clock, each ending in a synchronise; on the card the peak
    from ``max_memory_allocated`` after a reset, with the arguments
    already there (on the CPU: null); whether every floating-point output
    is finite."""
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    arg_bytes = sum(t.numel() * t.element_size()
                    for t in _leaves(args) if isinstance(t, torch.Tensor))
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = ops.launch_counts()
    out = step(*args)
    sync()
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()
                if v > before[k]}
    ms = []
    for _ in range(runs):
        del out
        t0 = time.perf_counter()
        out = step(*args)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    finite = all(_finite(t) for t in _leaves(out)
                 if isinstance(t, torch.Tensor) and t.is_floating_point())
    return out, {"ms": sorted(ms)[len(ms) // 2], "ms_runs": ms,
                 "finite": finite,
                 "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                if cuda else None),
                 "argument_bytes": arg_bytes, "launches": launches,
                 "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}


def _finite(t) -> bool:
    """Every element of ``t`` finite, read from its min and max (which
    carry a NaN through) without a tensor of ``t``'s size."""
    if t.numel() == 0:
        return True
    lo, hi = torch.aminmax(t)
    return bool(torch.isfinite(lo) & torch.isfinite(hi))


def _leaves(tree) -> list:
    out = []
    rules_lib.tree_map(out.append, tree)
    return out


def card_cell(arch, shape_name, variant="baseline", seed=0, rows=None,
              device=None):
    """(record, last output or None): the cell on the card mesh, run on
    ``device`` (the GPU unless ``device="cpu"``) from arguments made from
    ``seed`` when its reckoning fits in CARD_BYTES.  ``rows`` cuts an LM
    cell's global batch (the record's ``rows``)."""
    dev = resolve_device(device)
    if arch == "ingp-asdr":
        record, step, args, bundle = asdr_record(shape_name, "card", variant,
                                                 device=dev)
        need = reckon_bytes(record, bundle)

        def make_inputs():
            return asdr_inputs(bundle, shape_name, args, seed, dev)
    else:
        shape = SHAPES[shape_name]
        if rows is not None:
            shape = dataclasses.replace(shape, global_batch=rows)
        record, step, args, cfg = lm_record(arch, shape, "card", variant,
                                            device=dev)
        if rows is not None:
            record["rows"] = rows
        need = reckon_bytes(record)

        def make_inputs():
            return lm_inputs(cfg, shape, args, seed, dev)
    record["reckoned_bytes"] = need
    record["measured"] = None
    if need > CARD_BYTES:
        record["not_measured"] = (f"reckoned {need / 1e9:.1f} GB > "
                                  f"{CARD_BYTES / 1e9:.0f} GB")
        return _finish(record), None
    out, m = measure(step, make_inputs(), dev)
    if record["roofline"] is not None:
        bound_s = max(record["roofline"]["compute_s"],
                      record["roofline"]["memory_s"])
        m["bound_ms"] = 1e3 * bound_s
        m["roofline_share"] = 1e3 * bound_s / m["ms"]
    else:
        m["bound_ms"] = m["roofline_share"] = None
    record["measured"] = m
    return _finish(record), out


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single",
             variant: str = "baseline", seed: int = 0, api=None):
    """The cell's record on ``mesh_kind`` (single, multi or card); ``api``
    builds a logical mesh's LM record (``record_api``)."""
    if mesh_kind == "card":
        return card_cell(arch, shape_name, variant, seed)[0]
    if arch == "ingp-asdr":
        return _finish(asdr_record(shape_name, mesh_kind, variant)[0])
    return _finish(lm_record(arch, SHAPES[shape_name], mesh_kind, variant,
                             api=api)[0])


def cells(arch=None, shape=None, mesh="single", all_cells=False):
    """[(arch, shape, mesh)] the CLI's flags select: ``--all`` (or no
    ``--arch``) takes the ten LM archs and ingp-asdr, each on its own
    shapes."""
    archs = (configs.list_archs() + ["ingp-asdr"]
             if (all_cells or not arch) else [arch])

    def shapes_for(a):
        # ingp-asdr has its own shape set
        if a == "ingp-asdr":
            return list(ASDR_SHAPES) if not shape else [shape]
        return list(SHAPES) if (all_cells or not shape) else [shape]

    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    return [(a, s, m) for a in archs for s in shapes_for(a) for m in meshes]


def summary(rec) -> str:
    """One line of a record: per-device argument GB, the roofline terms
    and bottleneck, the measured reading."""
    mem = rec["memory"]["argument_bytes"] / 1e9
    r = rec["roofline"]
    line = f"args {mem:.3f} GB/device"
    if r is not None:
        line += (f" compute {r['compute_s']:.4f}s memory {r['memory_s']:.4f}s"
                 f" -> {r['bottleneck']}")
    m = rec.get("measured")
    if m:
        share, peak = m["roofline_share"], m["peak_bytes"]
        line += (f"; measured {m['ms']:.1f} ms"
                 + (f", peak {peak / 1e9:.2f} GB" if peak is not None else "")
                 + f" (reckoned {rec['reckoned_bytes'] / 1e9:.2f} GB)"
                 + (f", roofline share {share:.3f}" if share else ""))
    elif "not_measured" in rec:
        line += f"; not measured: {rec['not_measured']}"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "card"],
                    help="card = the one H100: analytic records plus a "
                         "measured run of each cell that fits (the GPU)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"],
                    help="opt = §Perf hillclimb configuration")
    ap.add_argument("--seed", type=int, default=0,
                    help="inputs of the cells measured on the card")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    if args.mesh == "card":
        resolve_device(None)         # the card mesh runs on the GPU
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    suffix = "" if args.variant == "baseline" else f"_{args.variant}"
    apis = {}
    for arch, shape_name, mesh_kind in cells(args.arch, args.shape,
                                             args.mesh, args.all):
        tag = f"{arch}_{shape_name}_{mesh_kind}{suffix}"
        out_path = outdir / f"{tag}.json"
        if out_path.exists():
            print(f"[skip-done] {tag}")
            continue
        if cell_is_skipped(arch, shape_name):
            out_path.write_text(json.dumps(
                {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "skipped": True,
                 "reason": "long_500k needs sub-quadratic attention"},
                indent=1))
            print(f"[skip] {tag}: full-attention arch")
            continue
        print(f"[run ] {tag} ...", flush=True)
        try:
            if arch != "ingp-asdr" and arch not in apis:
                apis[arch] = record_api(arch)
            rec = run_cell(arch, shape_name, mesh_kind, variant=args.variant,
                           seed=args.seed, api=apis.get(arch))
            rec["variant"] = args.variant
            out_path.write_text(json.dumps(rec, indent=1))
            print(f"[ok  ] {tag}: {summary(rec)}", flush=True)
        except Exception as e:  # noqa: BLE001 — recorded per cell, as the reference
            err = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                   "error": str(e)[:2000],
                   "traceback": traceback.format_exc()[-4000:]}
            (outdir / f"{tag}.error.json").write_text(json.dumps(err,
                                                                 indent=1))
            print(f"[FAIL] {tag}: {str(e)[:200]}", flush=True)


if __name__ == "__main__":
    main()
