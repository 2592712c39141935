"""Scene-shaped fields from the seed: the benchmark's weights.

Random Instant-NGP weights render a fog: nearly every pixel takes the
full sample count and most Phase-II blocks exit at once, which is not the
work adaptive sampling does on a real scene.  So set-up draws each
field's hash tables and MLP weights on the device (a ``torch.Generator``
there, in a few large calls) and fits them, in plain PyTorch, by
regression on drawn points of the unit cube to an analytic scene's
density (in log space) and colour, for the fixed number of steps the
configuration states.  The fit runs under
``torch.use_deterministic_algorithms``, so it gives the same tensors bit
for bit every time.  It does not depend on the seed, so a run keeps it
in the checkout (``fit_cached``) and only a checkout's first run of a
configuration and scene pays for it, as only its first run builds the
kernels.

The seed then arranges the fitted weights: it permutes the units of
every hidden layer, the geometry features and each level's feature
channels, with the matching rows and columns of the next layer.  The
tensors differ from seed to seed, the function they compute does not
(up to the order of float sums), so every seed renders the same work:
fits from seeded starts differed enough to move the frame rate by 3 %
between seeds (H100, lego).

Params: ``{"grid": (L, T, F), "density": [W...], "color": [W...]}``, each
W a (fan_in, fan_out) float32 matrix, as ``reference/ngp.py`` reads them.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
from pathlib import Path

import torch

from ..reference import ngp
from . import scenes


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for ``seed`` and a small stream number."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def init_params(cfg: dict, device) -> dict:
    """Tables uniform in +-1e-4 and Glorot-uniform weights, two draws."""
    grid = cfg["grid"]
    L, T, F = grid["n_levels"], ngp.table_rows(cfg), grid["feature_dim"]
    g = generator(0, 0, device)
    tables = (torch.rand((L, T, F), generator=g, device=device) * 2 - 1) * 1e-4
    density, color = ngp.mlp_sizes(cfg)
    shapes = ([(a, b) for a, b in zip(density[:-1], density[1:])]
              + [(a, b) for a, b in zip(color[:-1], color[1:])])
    flat = torch.rand((sum(a * b for a, b in shapes),), generator=g,
                      device=device) * 2 - 1
    ws, at = [], 0
    for a, b in shapes:
        ws.append(flat[at:at + a * b].reshape(a, b) * (6.0 / (a + b)) ** 0.5)
        at += a * b
    nd = len(density) - 1
    return {"grid": tables, "density": ws[:nd], "color": ws[nd:]}


def encode_all_levels(points, tables, grid: dict):
    """The hash-grid encoding of ``reference/ngp.py`` with every level and
    corner in one gather, for the fit's backward."""
    L, T, F = tables.shape
    dev = points.device
    res = torch.tensor(ngp.level_resolutions(grid), device=dev)
    corners = torch.tensor(ngp.CORNERS, device=dev)
    scaled = points[:, None, :] * res[None, :, None].float()
    base = torch.minimum(torch.clamp(torch.floor(scaled).long(), min=0),
                         (res - 1)[None, :, None])
    frac = scaled - base.float()
    c = base[:, :, None, :] + corners[None, None]              # (N, L, 8, 3)
    s = (res + 1)[None, :, None]
    dense = c[..., 0] + s * (c[..., 1] + s * c[..., 2])
    h = (c[..., 0] * ngp.PRIMES[0]) & ngp._U32
    h = h ^ ((c[..., 1] * ngp.PRIMES[1]) & ngp._U32)
    h = h ^ ((c[..., 2] * ngp.PRIMES[2]) & ngp._U32)
    idx = torch.where(((res + 1) ** 3 <= T)[None, :, None], dense, h % T)
    idx = idx + (torch.arange(L, device=dev) * T)[None, :, None]
    feats = torch.index_select(tables.reshape(L * T, F), 0, idx.reshape(-1))
    w = torch.where(corners.bool()[None, None], frac[:, :, None, :],
                    1.0 - frac[:, :, None, :]).prod(dim=-1)     # (N, L, 8)
    enc = (feats.reshape(*w.shape, F) * w[..., None]).sum(dim=2)
    return enc.reshape(points.shape[0], L * F)


@contextlib.contextmanager
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def fit(params: dict, cfg: dict, scene: str, device) -> dict:
    """``params`` regressed to the named analytic scene for
    ``cfg["fit"]["steps"]`` Adam steps of ``points`` drawn points each:
    the density logit against ``log(sigma + density_eps)`` everywhere, the
    colour against the scene's where the scene is dense."""
    fc = cfg["fit"]
    truth = scenes.make_scene(scene)
    g = generator(0, 1 + sorted(scenes.SCENES).index(scene), device)
    leaves = [params["grid"], *params["density"], *params["color"]]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    nd = len(params["density"])
    grid_t, dws, cws = leaves[0], leaves[1:1 + nd], leaves[1 + nd:]
    opt = torch.optim.Adam(leaves, lr=fc["lr"], betas=(0.9, 0.99), eps=1e-15,
                           foreach=False)
    n = fc["points"]
    with deterministic():
        for _ in range(fc["steps"]):
            pts = torch.rand((n, 3), generator=g, device=device)
            dirs = torch.randn((n, 3), generator=g, device=device)
            dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
            with torch.no_grad():
                sig_t, col_t = truth(pts)
            out = ngp.mlp(dws, encode_all_levels(pts, grid_t, cfg["grid"]))
            loss_d = torch.mean(
                (out[:, 0] - torch.log(sig_t + fc["density_eps"])) ** 2)
            col = torch.sigmoid(ngp.mlp(
                cws, torch.cat([out[:, 1:], ngp.sh_encode(dirs)], dim=-1)))
            solid = (sig_t > fc["solid_sigma"]).float()
            loss_c = (torch.sum(solid * torch.sum((col - col_t) ** 2, dim=-1))
                      / torch.clamp(solid.sum(), min=1.0))
            opt.zero_grad(set_to_none=True)
            (loss_d + fc["color_weight"] * loss_c).backward()
            opt.step()
    del opt
    return {"grid": grid_t.detach(), "density": [w.detach() for w in dws],
            "color": [w.detach() for w in cws]}


def arrange(params: dict, cfg: dict, seed: int, device) -> dict:
    """The same field with its units in an order drawn from ``seed``:
    each hidden layer's units, the geometry features (density output
    columns 1.. and the colour chain's first rows) and each level's
    feature channels (with the density chain's first rows)."""
    g = generator(seed, 100, device)

    def perm(n):
        return torch.randperm(n, generator=g, device=device)

    L, _, F = params["grid"].shape
    chan = torch.stack([perm(F) for _ in range(L)])              # (L, F)
    grid = torch.gather(params["grid"], 2,
                        chan[:, None, :].expand_as(params["grid"]))
    rows = (torch.arange(L, device=device)[:, None] * F + chan).reshape(-1)
    density = list(params["density"])
    color = list(params["color"])
    density[0] = density[0][rows]
    for ws in (density, color):
        for i in range(len(ws) - 1):
            p = perm(ws[i].shape[1])
            ws[i], ws[i + 1] = ws[i][:, p], ws[i + 1][p]
    geo = perm(density[-1].shape[1] - 1)
    density[-1] = torch.cat([density[-1][:, :1], density[-1][:, 1 + geo]],
                            dim=1)
    color[0] = torch.cat([color[0][geo], color[0][len(geo):]])
    return {"grid": grid.contiguous(),
            "density": [w.contiguous() for w in density],
            "color": [w.contiguous() for w in color]}


def fit_key(cfg: dict, scene: str, device) -> str:
    """What the fitted tensors depend on: the widths and the fit's
    settings, the scene, the code that draws and fits them, the torch
    build and the device."""
    src = Path(__file__).resolve().parent.parent
    parts = [json.dumps({k: cfg[k] for k in ("grid", "mlp", "fit")},
                        sort_keys=True), scene, torch.__version__,
             (torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu")]
    parts += [(src / f).read_text() for f in
              ("inputs/field.py", "inputs/scenes.py", "reference/ngp.py")]
    return hashlib.sha256("\0".join(parts).encode()).hexdigest()[:24]


def fit_cached(cfg: dict, scene: str, device, cache_dir) -> dict:
    """``fit(init_params(...))`` of ``scene``, from ``cache_dir`` where an
    earlier run left it, else fitted and left there (``None``: no cache)."""
    if cache_dir is None:
        return fit(init_params(cfg, device), cfg, scene, device)
    path = Path(cache_dir) / f"{scene}-{fit_key(cfg, scene, device)}.pt"
    if path.exists():
        return torch.load(path, map_location=device, weights_only=True)
    params = fit(init_params(cfg, device), cfg, scene, device)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(path.name + ".part")
    torch.save(params, part)
    os.replace(part, path)
    return params


def make_fields(cfg: dict, scene_names, seed: int, device,
                cache_dir=None) -> dict:
    """{scene: fitted params, arranged by ``seed``} for each scene a cell
    renders; the fits kept in ``cache_dir`` (``fit_cached``)."""
    if device.type == "cuda" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError("set CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA "
                           "starts: the fit's matmuls must be deterministic")
    return {name: arrange(fit_cached(cfg, name, device, cache_dir), cfg,
                          seed, device)
            for name in scene_names}
