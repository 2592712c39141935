"""Production-mesh steps for the paper's own model (ingp-asdr, the 11th
config; ``repro.launch.asdr_steps``).

The ASDR renderer and NGP trainer run through the same launcher/dry-run
path as the LM zoo:

  * ``asdr_render``: Phase II of an 800x800 frame — rays + per-pixel
    counts (Phase I output) sharded over (pod, data); difficulty-sorted
    blocks march chunk by chunk with early termination; the color MLP
    runs on every ``group``-th sample only (§4.3).
  * ``asdr_train``: photometric training step over 2^18 rays — grid
    tables sharded over ``model`` rows (the Mem-Xbar distribution
    analogue), ray batch over (pod, data), AdamW update.

Each builder returns ``(step, arg_specs, extra)``: ``step`` a
``launch.mesh.Step`` whose specs are the reference's shardings,
``arg_specs`` meta tensors of the reference's shapes and dtypes, ``extra``
the reference's dict.  The step runs eagerly on its arguments' device: on
the card it renders through the kernel field (``kernels/ops.field_fns``:
``hash_encode``, ``density_mlp``, ``color_mlp``), on the CPU through the
plain field (``core/model.field_fns``).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import optim
from ..core import model as model_lib
from ..core import pipeline, scene
from ..core.model import NGPConfig
from ..kernels import ops
from ..sharding.rules import PartitionSpec as P
from ..train.step import make_loss_and_grads
from .mesh import Step

RENDER_HW = (800, 800)          # paper's Synthetic-NeRF resolution
RENDER_BLOCK = 4096
TRAIN_RAYS = 1 << 18
TRAIN_SAMPLES = 128
# the main path's view of the frame (``chip_smoke.py``'s CAMERA) and its
# field's hash tables, uniform(-scale, scale): large enough that the frame
# holds several rungs of the count ladder and most blocks exit early
RENDER_VIEW = dict(theta=0.9, phi=0.55)
RENDER_TABLE_SCALE = 30.0
# floats a sample holds beyond the MLP layers: sigma, alpha, its log,
# weight, t, the cumulated transmittance, and the lerped colour
_SAMPLE_EXTRA_FLOATS = 9


def _batch_spec(mesh):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    return tuple(axes) if len(axes) > 1 else axes[0]


def param_shardings(cfg: NGPConfig, mesh, shard_tables: bool):
    """The params' specs: tables sharded over ``model`` rows or
    replicated, the MLPs replicated."""
    del mesh
    table_spec = P(None, "model", None) if shard_tables else P()
    return {
        "grid": table_spec,
        "mlps": {
            "density": [P() for _ in range(2)],
            "color": [P() for _ in range(
                4 if cfg.net.color_layers == 3 else 3)],
        },
    }


def abstract_params(cfg: NGPConfig):
    """The params dict on the meta device."""
    return model_lib.init_ngp(cfg, torch.zeros(2, dtype=torch.int64),
                              device="meta")


def field_fns(params, cfg: NGPConfig):
    """The reference's ``model_lib.field_fns(params, cfg)``: the kernel
    field on the card, the plain field on the CPU."""
    field = model_lib.NGPField.from_params(cfg, params)
    if field.grid.device.type == "cuda":
        return ops.field_fns(field)
    return model_lib.field_fns(field)


def build_render_cell(bundle, mesh, variant: str = "baseline"):
    """baseline: grid tables sharded over `model` rows (the literal Mem-Xbar
    distribution — every voxel-corner lookup crosses shards).
    opt (§Perf): the paper's own §5.2.1 insight — the tables are small
    enough (67 MB) to REPLICATE per chip, as the paper replicates de-hashed
    low-res tables into spare crossbar rows.

    The step returns ``render_adaptive``'s (rgb, acc, stats); the
    reference's jitted step keeps rgb."""
    cfg = bundle.model
    acfg = dataclasses.replace(bundle.asdr, block_size=RENDER_BLOCK)
    H, W = RENDER_HW
    R = -(-H * W // RENDER_BLOCK) * RENDER_BLOCK  # pad to block multiple

    def render(params, origins, dirs, counts):
        return pipeline.render_adaptive(field_fns(params, cfg), acfg,
                                        origins, dirs, counts)

    b = _batch_spec(mesh)
    p_sh = param_shardings(cfg, mesh, shard_tables=(variant != "opt"))
    ray_sh = P(b, None)
    cnt_sh = P(b)
    step = Step(render, (p_sh, ray_sh, ray_sh, cnt_sh))
    args = (
        abstract_params(cfg),
        torch.empty((R, 3), dtype=torch.float32, device="meta"),
        torch.empty((R, 3), dtype=torch.float32, device="meta"),
        torch.empty((R,), dtype=torch.int32, device="meta"),
    )
    return step, args, {"scan_multiplier": R // RENDER_BLOCK,
                        "rays": R, "block": RENDER_BLOCK}


def render_inputs(fns, bundle, cam, device=None):
    """The render cell's rays and counts for camera ``cam``: its Phase I
    (``probe_phase``) counts, rays padded to a multiple of RENDER_BLOCK."""
    acfg = dataclasses.replace(bundle.asdr, block_size=RENDER_BLOCK)
    o, d = scene.camera_rays(cam, device=device)
    counts, _ = pipeline.probe_phase(fns, acfg, cam, device=device)
    o, d, counts, _, _ = pipeline.pad_rays_to_blocks(acfg, o, d, counts)
    return o, d, counts


def opt_config():
    return optim.AdamWConfig(lr=5e-3, b2=0.99, eps=1e-15)


def build_train_cell_ngp(bundle, mesh):
    cfg = bundle.model
    opt_cfg = opt_config()

    def loss_fn(p, batch):
        origins, dirs, ref = batch
        rgb, _ = pipeline.render_fixed_fns(model_lib.param_fns(p, cfg),
                                           origins, dirs, TRAIN_SAMPLES)
        return torch.mean((rgb - ref) ** 2)

    grads_fn = make_loss_and_grads(loss_fn, 1)

    def step(params, opt_state, origins, dirs, ref, lr):
        loss, grads = grads_fn(params, (origins, dirs, ref))
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt_state = optim.adamw_update(grads, opt_state, params,
                                               opt_cfg, lr)
        return params, opt_state, loss

    b = _batch_spec(mesh)
    p_sh = param_shardings(cfg, mesh, shard_tables=True)
    o_sh = {"m": p_sh, "v": p_sh, "count": P()}
    ray_sh = P(b, None)
    scalar = P()
    params_abs = abstract_params(cfg)
    opt_abs = optim.adamw_init(params_abs, opt_cfg)
    loss_abs = torch.empty((), dtype=torch.float32, device="meta")
    step_fn = Step(step, (p_sh, o_sh, ray_sh, ray_sh, ray_sh, scalar),
                   out_specs=(p_sh, o_sh, scalar),
                   outs=(params_abs, opt_abs, loss_abs))
    args = (
        params_abs, opt_abs,
        torch.empty((TRAIN_RAYS, 3), dtype=torch.float32, device="meta"),
        torch.empty((TRAIN_RAYS, 3), dtype=torch.float32, device="meta"),
        torch.empty((TRAIN_RAYS, 3), dtype=torch.float32, device="meta"),
        torch.empty((), dtype=torch.float32, device="meta"),
    )
    return step_fn, args, {"scan_multiplier": 1, "rays": TRAIN_RAYS}


def sample_floats(cfg: NGPConfig, color_share: float = 1.0) -> float:
    """Floats one sample holds through a field call: its point, every
    layer's input and output of the density chain, ``color_share`` of the
    color chain's (anchors only where the §4.3 lerp runs) and a few
    per-sample scalars."""
    return (3 + sum(cfg.net.density_sizes())
            + color_share * sum(cfg.net.color_sizes()) + _SAMPLE_EXTRA_FLOATS)


def working_bytes(bundle, shape_name: str, extra: dict) -> float:
    """A reckoning of the bytes a step holds beyond its arguments on one
    card.  Render: one field call of the reference march
    (``pipeline.MARCH_SAMPLES_PER_CALL`` samples at most, color on every
    ``group``-th) plus ten floats a ray of march state and outputs.
    Train: every sample's activations kept for the backward and their
    gradients, plus four more copies of the params (gradients, the update's
    new params and moments)."""
    cfg, acfg = bundle.model, bundle.asdr
    if shape_name == "asdr_train":
        acts = (extra["rays"] * TRAIN_SAMPLES * sample_floats(cfg) * 4 * 2)
        params = sum(t.numel() for t in optim.tree_leaves(
            abstract_params(cfg))) * 4
        return float(acts + 4 * params)
    rays = extra.get("rays", extra.get("rays_per_call", 0))
    block = extra["block"]
    per_call = max(1, pipeline.MARCH_SAMPLES_PER_CALL // (block * acfg.chunk))
    if shape_name == "render_serve":
        per_call = 1                 # one pooled block a march call
    samples = min(rays, per_call * block) * acfg.chunk
    return float(samples * sample_floats(cfg, 1.0 / acfg.group) * 4
                 + rays * 10 * 4)
