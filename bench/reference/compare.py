"""The comparison that decides ``correct``: a frame the program rendered
against the plain reference's frame of the same pose on the same inputs.

The blocks of a frame are its rays sorted by sample count, so one pixel
whose count rounds the other way moves a block boundary and can change a
block's budget, and with it where every ray of that block samples.  So
the comparison first counts such pixels and blocks, then compares rgb,
depth and each ray's chunks on the pixels whose count, block budget and
block chunk count agree ("matched"):

- ``count_diff``: share of pixels whose Phase-I count differs;
- ``block_diff``: share of pixels whose block's budget or chunk count
  differs (the block order and budgets, and the march's block counters);
- ``ray_chunk_diff``: share of matched pixels whose own chunk count
  differs (the march's per-ray counters);
- ``rgb_max_err`` and ``depth_max_err``: the largest absolute gap of a
  matched pixel's Phase-II colour and termination depth.

Each number is taken as the worst over the frames compared; each has its
limit in the cell's workload file.
"""
from __future__ import annotations

import torch


def pixel_blocks(counts, budgets, chunks, ray_chunks, block: int,
                 pad_count: int):
    """Per pixel (H*W,): its block's budget and chunks and its own ray
    chunks, from a frame's counts (the stable sort by count gives each
    pixel its block, as Phase II sorts them)."""
    R = counts.shape[0]
    pad = (-R) % block
    cp = torch.cat([counts.to(torch.int32),
                    torch.full((pad,), pad_count, dtype=torch.int32,
                               device=counts.device)])
    order = torch.argsort(cp, stable=True)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(R + pad, device=counts.device)
    pos = pos[:R]
    blk = pos // block
    return (budgets.to(torch.int64)[blk], chunks.to(torch.int64)[blk],
            ray_chunks.reshape(-1).to(torch.int64)[pos])


def frame_numbers(prog, ref, cfg: dict) -> dict:
    """``prog`` and ``ref``: dicts of ``image`` (H, W, 3), ``counts``
    (H*W,), ``budgets`` and ``chunks`` (blocks,), ``ray_chunks`` (blocks,
    B) and ``depth`` (H*W,) in pixel order."""
    a = cfg["asdr"]
    dev = ref["counts"].device
    p = {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in prog.items()}
    R = ref["counts"].shape[0]
    pad_count = min(a["candidates"])
    pb = pixel_blocks(p["counts"], p["budgets"], p["chunks"],
                      p["ray_chunks"], a["block_size"], pad_count)
    rb = pixel_blocks(ref["counts"], ref["budgets"], ref["chunks"],
                      ref["ray_chunks"], a["block_size"], pad_count)
    same_count = p["counts"].to(torch.int64) == ref["counts"].to(torch.int64)
    same_block = (pb[0] == rb[0]) & (pb[1] == rb[1])
    matched = same_count & same_block
    n_m = max(int(matched.sum()), 1)
    gap_rgb = torch.abs(p["image"].reshape(R, 3).float()
                        - ref["image"].reshape(R, 3).float()).max(dim=-1).values
    gap_depth = torch.abs(p["depth"][:R].float() - ref["depth"][:R].float())
    # a NaN or inf in the program's output is as far as it can be
    gap_rgb = torch.nan_to_num(gap_rgb, nan=float("inf"))
    gap_depth = torch.nan_to_num(gap_depth, nan=float("inf"))
    zero = torch.zeros((), device=dev)
    return {
        "count_diff": float((~same_count).float().mean()),
        "block_diff": float((~same_block).float().mean()),
        "ray_chunk_diff": float(((pb[2] != rb[2]) & matched).sum()) / n_m,
        "rgb_max_err": float(torch.where(matched, gap_rgb, zero).max()),
        "depth_max_err": float(torch.where(matched, gap_depth, zero).max()),
    }


def worst(readings) -> dict:
    """The largest of each number over the frames compared."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): correct when every number is
    at most its limit (a NaN is not)."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
