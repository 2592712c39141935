"""The plain reference of TensoRF's VM field (arXiv:2203.09517,
``TensorVMSplit`` with ``shadingMode MLP_Fea``), in float32 PyTorch
operations and TensoRF's own layout: planes (1, C, H, W), lines
(1, C, H, 1), read by ``grid_sample`` with ``align_corners=True``.

It reads a configuration file's ``tensorf`` group and a params dict
``{"density_plane", "density_line", "app_plane", "app_line": [3 tensors],
"basis": (app_dim, sum of app components), "mlp": [W1, b1, W2, b2, W3,
b3]}`` (``nn.Linear``'s (out, in) weights).  The renderer's unit cube
stands for TensoRF's aabb, ``aabb_size`` world units a side, so the
sigma returned is ``softplus(feature + density_shift) * distance_scale *
aabb_size``, zero outside the cube.  It sets TF32 off, imports nothing of
the program, and plugs into ``asdr.render_frame`` as its field.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)
POINTS_PER_CALL = 1 << 20


def positional_encoding(x, freqs: int):
    bands = 2.0 ** torch.arange(freqs, dtype=torch.float32, device=x.device)
    pts = (x[..., None] * bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)


class Field:
    """density(points) -> (sigma (N,), geo = points); color(points, dirs)
    -> rgb (N, 3)."""

    def __init__(self, params: dict, cfg: dict):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p = params
        t = cfg["tensorf"]
        self.shift = t["density_shift"]
        self.scale = t["distance_scale"] * t["aabb_size"]
        self.fea_pe, self.view_pe = t["fea_pe"], t["view_pe"]

    def _coords(self, points):
        xyz = points * 2.0 - 1.0
        plane = torch.stack([xyz[..., list(m)] for m in MAT_MODE]).view(
            3, -1, 1, 2)
        line = torch.stack([xyz[..., v] for v in VEC_MODE])
        line = torch.stack([torch.zeros_like(line), line], dim=-1).view(
            3, -1, 1, 2)
        return plane, line

    def _sample(self, planes, lines, points):
        n = points.shape[0]
        cp, cl = self._coords(points)
        ps = [F.grid_sample(planes[i], cp[[i]], align_corners=True).view(-1, n)
              for i in range(3)]
        ls = [F.grid_sample(lines[i], cl[[i]], align_corners=True).view(-1, n)
              for i in range(3)]
        return ps, ls

    def _density(self, points):
        ps, ls = self._sample(self.p["density_plane"], self.p["density_line"],
                              points)
        f = torch.zeros((points.shape[0],), device=points.device)
        for p, l in zip(ps, ls):
            f = f + torch.sum(p * l, dim=0)
        sigma = F.softplus(f + self.shift) * self.scale
        inside = torch.all((points >= 0.0) & (points <= 1.0), dim=-1)
        return torch.where(inside, sigma, 0.0)

    def _color(self, points, dirs):
        ps, ls = self._sample(self.p["app_plane"], self.p["app_line"], points)
        feats = F.linear((torch.cat(ps) * torch.cat(ls)).T, self.p["basis"])
        x = torch.cat([feats, dirs, positional_encoding(feats, self.fea_pe),
                       positional_encoding(dirs, self.view_pe)], dim=-1)
        w = self.p["mlp"]
        x = torch.relu(F.linear(x, w[0], w[1]))
        x = torch.relu(F.linear(x, w[2], w[3]))
        return torch.sigmoid(F.linear(x, w[4], w[5]))

    def density(self, points):
        n = points.shape[0]
        sigma = torch.cat([self._density(points[s:s + POINTS_PER_CALL])
                           for s in range(0, n, POINTS_PER_CALL)])
        return sigma, points

    def color(self, points, dirs):
        n = points.shape[0]
        return torch.cat([self._color(points[s:s + POINTS_PER_CALL],
                                      dirs[s:s + POINTS_PER_CALL])
                          for s in range(0, n, POINTS_PER_CALL)])
