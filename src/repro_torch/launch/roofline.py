"""Roofline terms on one NVIDIA H100 (``repro.launch.roofline``).

Three terms per cell, all in seconds:

  compute    = FLOPs / peak_FLOPs
  memory     = bytes / HBM_bw
  collective = collective_bytes / link_bw

The port emits no HLO: ``launch/dryrun.py`` feeds ``roofline_terms`` the
analytic per-chip FLOPs and bytes (``launch/analytic.py``), with
collectives 0 on a logical mesh.  ``collective_bytes`` and
``_shape_bytes`` stay the reference's text parser of post-optimization
XLA HLO, so the reference's dry-run artifacts can be read beside the
port's records.

Hardware constants: one H100 SXM at its 700 W limit (NVIDIA's data
sheet): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3,
NVLink 900 GB/s both ways, 450 GB/s each way.
"""
from __future__ import annotations

import re
from typing import Dict

PEAK_FLOPS = 989e12          # dense bf16 per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 450e9              # bytes/s, NVLink, each way

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """'f32[16,128]' -> byte size; tuples handled by caller."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str, body_multiplier: int = 1) -> Dict[str, int]:
    """Sum output-shape bytes of every collective op in the HLO text.

    XLA's HLO lists a while-loop (scan) body computation ONCE regardless of
    trip count, so collectives inside scan bodies (the per-layer FSDP
    all-gathers / TP all-reduces) are undercounted by the trip count.  We
    therefore track which computation each collective appears in: ops in
    the ENTRY computation count once; ops in any sub-computation are
    multiplied by ``body_multiplier`` (the caller passes the structurally
    known scan trip product, e.g. n_layers * microbatches for a train
    step).  This slightly overcounts collectives in non-loop
    sub-computations (rare).

    Returns {op_kind: bytes, ..., "entry": b, "body_raw": b,
             "total": corrected bytes, "count": n}.
    """
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    entry_b = 0
    body_b = 0
    count = 0
    in_entry = False
    for line in hlo_text.splitlines():
        s = line.strip()
        if s.startswith("ENTRY "):
            in_entry = True
            continue
        if s.startswith("}"):
            in_entry = False
            continue
        m = re.match(r"[%\w.\-]+\s*=\s*(.+?)\s+([\w\-]+)\(", s)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        kind = None
        for c in _COLLECTIVES:
            if op == c or op.startswith(c + "-"):  # e.g. all-reduce-start
                kind = c
                break
        if kind is None:
            continue
        if op.endswith("-done"):
            continue  # counted at -start
        b = _shape_bytes(shape_str)
        mult = 1 if in_entry else body_multiplier
        out[kind] += b * mult
        if in_entry:
            entry_b += b
        else:
            body_b += b
        count += 1
    out["entry"] = entry_b
    out["body_raw"] = body_b
    out["total"] = entry_b + body_b * body_multiplier
    out["count"] = count
    return out


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> Dict[str, float]:
    compute = flops / PEAK_FLOPS
    memory = bytes_accessed / HBM_BW
    collective = coll_bytes / LINK_BW
    terms = {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
    }
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["roofline_fraction_compute"] = compute / total if total else 0.0
    return terms


def model_flops(cfg, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference fwd), N = active."""
    n = cfg.active_param_count() if hasattr(cfg, "active_param_count") else 0
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
