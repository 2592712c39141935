"""Scene-shaped TensoRF VM fields from the seed: the VM cell's weights.

As ``field.py`` does for Instant-NGP: set-up draws the planes, lines,
basis and MLP on the device (a ``torch.Generator`` there; TensoRF's
``0.1 * randn`` grids, ``nn.Linear``'s uniform init, the last bias 0)
and fits every tensor, in plain PyTorch, by regression on drawn points
of the unit cube to an analytic scene: the density's log against
``log(sigma + density_eps)`` everywhere, the colour against the scene's
where the scene is dense, for the configuration's ``steps`` of Adam
(TensoRF's two learning rates, the grids' and the network's).  The fit
reads the tensors channels innermost by ``index_select`` (whose backward
is deterministic; ``grid_sample``'s is not) under
``torch.use_deterministic_algorithms``, so it gives the same tensors bit
for bit every time, and a checkout keeps it (``fit_cached``).

The seed then arranges the fitted field without changing its function
(up to the order of float sums): it permutes each pair's density
components (plane and line alike), each pair's appearance components
with their basis columns, and the MLP's hidden units with the next
layer's columns.

Params: TensoRF's layout, as ``reference/tensorf.py`` reads them.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from pathlib import Path

import torch

from ..reference import tensorf as ref_tensorf
from . import scenes
from .field import deterministic, generator

MAT_MODE, VEC_MODE = ref_tensorf.MAT_MODE, ref_tensorf.VEC_MODE
positional_encoding = ref_tensorf.positional_encoding


def _cfg(cfg: dict):
    t = cfg["tensorf"]
    app, vp, fp = t["app_dim"], t["view_pe"], t["fea_pe"]
    mlp_in = app + 3 + 2 * fp * app + 2 * vp * 3
    return t, [mlp_in, t["hidden"], t["hidden"], 3]


def init_params(cfg: dict, device) -> dict:
    """Channels-innermost grids (planes (H*W, C), lines (H, C)) and the
    network, for the fit."""
    t, sizes = _cfg(cfg)
    r = t["resolution"]
    g = generator(0, 0, device)

    def randn(n, c):
        return torch.randn((n, c), generator=g, device=device) * 0.1

    def uniform(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * b

    p = {}
    for kind, comps in (("density", t["density_components"]),
                        ("app", t["app_components"])):
        p[f"{kind}_plane"] = [randn(r[a] * r[b], c)
                              for (a, b), c in zip(MAT_MODE, comps)]
        p[f"{kind}_line"] = [randn(r[v], c) for v, c in zip(VEC_MODE, comps)]
    p["basis"] = uniform((t["app_dim"], sum(t["app_components"])),
                         sum(t["app_components"]))
    mlp = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        mlp.append(uniform((b, a), a))
        mlp.append(torch.zeros((b,), device=device) if i == 2
                   else uniform((b,), a))
    p["mlp"] = mlp
    return p


def _lin(x, size: int):
    u = ((x + 1.0) / 2.0) * (size - 1)
    fl = torch.floor(u)
    i0 = fl.long()
    return [(i0, (fl + 1.0) - u), (i0 + 1, u - fl)]


def _taps(tab, corners):
    """sum over corners of tab[index] * weight, zero outside the tensor."""
    out = 0.0
    for idx, w, ok in corners:
        v = torch.index_select(tab, 0, idx.clamp(0, tab.shape[0] - 1))
        out = out + v * (w * ok)[:, None]
    return out


def vm_features(points, planes, lines, res):
    """[(plane (n, C), line (n, C))] of the three pairs, bilinear and
    linear as ``grid_sample`` with ``align_corners=True`` reads them."""
    xyz = points * 2.0 - 1.0
    out = []
    for i, ((a, b), v) in enumerate(zip(MAT_MODE, VEC_MODE)):
        W, H = res[a], res[b]
        xs, ys, zs = _lin(xyz[:, a], W), _lin(xyz[:, b], H), _lin(xyz[:, v],
                                                                  res[v])
        pc = [(y * W + x, wx * wy, ((x >= 0) & (x < W) & (y >= 0)
                                    & (y < H)).float())
              for y, wy in ys for x, wx in xs]
        lc = [(z, wz, ((z >= 0) & (z < res[v])).float()) for z, wz in zs]
        out.append((_taps(planes[i], pc), _taps(lines[i], lc)))
    return out


def _forward(p, cfg, pts, dirs):
    t, _ = _cfg(cfg)
    res = t["resolution"]
    dens = vm_features(pts, p["density_plane"], p["density_line"], res)
    f = sum((pl * li).sum(dim=1) for pl, li in dens)
    sigma = (torch.nn.functional.softplus(f + t["density_shift"])
             * t["distance_scale"] * t["aabb_size"])
    app = vm_features(pts, p["app_plane"], p["app_line"], res)
    feats = torch.cat([pl * li for pl, li in app], dim=1) @ p["basis"].t()
    x = torch.cat([feats, dirs, positional_encoding(feats, t["fea_pe"]),
                   positional_encoding(dirs, t["view_pe"])], dim=-1)
    w = p["mlp"]
    x = torch.relu(torch.nn.functional.linear(x, w[0], w[1]))
    x = torch.relu(torch.nn.functional.linear(x, w[2], w[3]))
    return sigma, torch.sigmoid(torch.nn.functional.linear(x, w[4], w[5]))


GRIDS = ("density_plane", "density_line", "app_plane", "app_line")


def fit(params: dict, cfg: dict, scene: str, device) -> dict:
    """``params`` regressed to the named analytic scene for ``steps`` Adam
    steps of ``points`` drawn points each."""
    fc = cfg["fit"]
    truth = scenes.make_scene(scene)
    g = generator(0, 1 + sorted(scenes.SCENES).index(scene), device)
    p = {k: ([x.detach().clone().requires_grad_(True) for x in v]
             if isinstance(v, list) else v.detach().clone()
             .requires_grad_(True)) for k, v in params.items()}
    grids = [x for k in GRIDS for x in p[k]]
    net = [p["basis"], *p["mlp"]]
    opt = torch.optim.Adam([{"params": grids, "lr": fc["lr_grid"]},
                            {"params": net, "lr": fc["lr_net"]}],
                           betas=(0.9, 0.99), eps=1e-15, foreach=False)
    n = fc["points"]
    with deterministic():
        for _ in range(fc["steps"]):
            pts = torch.rand((n, 3), generator=g, device=device)
            dirs = torch.randn((n, 3), generator=g, device=device)
            dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
            with torch.no_grad():
                sig_t, col_t = truth(pts)
            sigma, col = _forward(p, cfg, pts, dirs)
            loss_d = torch.mean((torch.log(sigma + fc["density_eps"])
                                 - torch.log(sig_t + fc["density_eps"])) ** 2)
            solid = (sig_t > fc["solid_sigma"]).float()
            loss_c = (torch.sum(solid * torch.sum((col - col_t) ** 2, dim=-1))
                      / torch.clamp(solid.sum(), min=1.0))
            opt.zero_grad(set_to_none=True)
            (loss_d + fc["color_weight"] * loss_c).backward()
            opt.step()
    del opt
    return to_tensorf_layout(p, cfg)


def to_tensorf_layout(p: dict, cfg: dict) -> dict:
    """Channels-innermost grids -> TensoRF's (1, C, H, W) planes and
    (1, C, H, 1) lines; the network as it is."""
    r = cfg["tensorf"]["resolution"]
    out = {}
    for kind in ("density", "app"):
        out[f"{kind}_plane"] = [
            x.detach().t().reshape(1, -1, r[b], r[a]).contiguous()
            for (a, b), x in zip(MAT_MODE, p[f"{kind}_plane"])]
        out[f"{kind}_line"] = [x.detach().t().reshape(1, -1, r[v], 1)
                               .contiguous()
                               for v, x in zip(VEC_MODE, p[f"{kind}_line"])]
    out["basis"] = p["basis"].detach().contiguous()
    out["mlp"] = [x.detach().contiguous() for x in p["mlp"]]
    return out


def arrange(params: dict, cfg: dict, seed: int, device) -> dict:
    """The same field with its components and hidden units in an order
    drawn from ``seed``."""
    g = generator(seed, 100, device)

    def perm(n):
        return torch.randperm(n, generator=g, device=device)

    out = {k: (list(v) if isinstance(v, list) else v)
           for k, v in params.items()}
    for i in range(3):
        pd = perm(out["density_plane"][i].shape[1])
        out["density_plane"][i] = out["density_plane"][i][:, pd]
        out["density_line"][i] = out["density_line"][i][:, pd]
    cols, at = [], 0
    for i in range(3):
        c = out["app_plane"][i].shape[1]
        pa = perm(c)
        out["app_plane"][i] = out["app_plane"][i][:, pa]
        out["app_line"][i] = out["app_line"][i][:, pa]
        cols.append(at + pa)
        at += c
    out["basis"] = out["basis"][:, torch.cat(cols)]
    w = list(out["mlp"])
    for i in (0, 2):
        ph = perm(w[i].shape[0])
        w[i], w[i + 1], w[i + 2] = w[i][ph], w[i + 1][ph], w[i + 2][:, ph]
    out["mlp"] = w
    return {k: ([x.contiguous() for x in v] if isinstance(v, list)
                else v.contiguous()) for k, v in out.items()}


def fit_key(cfg: dict, scene: str, device) -> str:
    src = Path(__file__).resolve().parent.parent
    parts = [json.dumps({k: cfg[k] for k in ("tensorf", "fit")},
                        sort_keys=True), scene, torch.__version__,
             (torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu")]
    parts += [(src / f).read_text() for f in
              ("inputs/field_tensorf.py", "inputs/field.py",
               "inputs/scenes.py")]
    return hashlib.sha256("\0".join(parts).encode()).hexdigest()[:24]


def fit_cached(cfg: dict, scene: str, device, cache_dir) -> dict:
    """``fit(init_params(...))`` of ``scene``, kept in ``cache_dir``."""
    if cache_dir is None:
        return fit(init_params(cfg, device), cfg, scene, device)
    path = Path(cache_dir) / f"tensorf-{scene}-{fit_key(cfg, scene, device)}.pt"
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
    """{scene: fitted VM params, arranged by ``seed``}."""
    if device.type == "cuda" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError("set CUBLAS_WORKSPACE_CONFIG=:4096:8 before CUDA "
                           "starts: the fit's matmuls must be deterministic")
    return {name: arrange(fit_cached(cfg, name, device, cache_dir), cfg,
                          seed, device)
            for name in scene_names}
