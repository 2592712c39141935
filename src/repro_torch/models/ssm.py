"""Mamba-2 SSD (``repro.models.ssm``): the chunked scan and O(1) decode.

Recurrence (per head h, state (P, N)):
    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t),   a_t = exp(dt_t * A)
    y_t = C_t · h_t + D * x_t

``ssd_scan`` splits the sequence into chunks of ``ssm_chunk``: within a
chunk a masked quadratic form, across chunks a Python loop carrying the
(H, P, N) state.  ``ssd_reference`` is the naive recurrence it is held to.

The reference builds each chunk's end state from a (B, C, Q, H, P, N)
float32 temporary (1.57 MB a token at mamba2-780m's widths, 6.4 GB for a
4,096-token prefill).  Here the decays and ``dt`` scale ``xs`` first, and
one batched product over the chunk's tokens gives the end state, so that
temporary is never built: the same sum in another order, held to the
reference by tolerance.

Parameters arrive as the port stores them (matrices in the model's dtype,
1-D leaves in float32); ``cast_tree`` casts every float leaf to the
compute dtype at use, as the reference's does, so in bf16 ``A_log``,
``D``, ``dt_bias`` and ``norm`` are rounded to bf16 where the reference
rounds them.  Decode (``ssm_step``) advances one token with a conv ring.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import prng
from ..core.scene import linspace
from ..device import resolve_device
from . import params as pp
from .params import P


class SSMState(NamedTuple):
    h: torch.Tensor      # (B, H*P, N) running state, float32
    conv: torch.Tensor   # (B, conv_w, C_in) conv ring (C_in = di + 2*G*N)


def ssm_init(key, cfg, dtype=torch.float32, device=None):
    """The reference's draws for ``key``: matrices (and the conv taps,
    2-D) stored in ``dtype``, the 1-D leaves in float32.  ``A_log`` is
    log(linspace(1, 16, H)) with XLA's float32 log and linspace."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, 1
    dev = resolve_device(device)
    ks = prng.split(key, 8)
    kw = dict(dtype=dtype, device=dev)
    conv_w = torch.empty((cfg.ssm_conv, di + 2 * G * N), **kw)
    a_log = (torch.empty(H, device="meta") if dev.type == "meta"
             else prng.xla_log(linspace(1.0, 16.0, H)).to(dev))
    return {
        "z_proj": pp.dense_init(ks[0], (d, di), ("d_model", "ssm_inner"), **kw),
        "x_proj": pp.dense_init(ks[1], (d, di), ("d_model", "ssm_inner"), **kw),
        "b_proj": pp.dense_init(ks[2], (d, G * N), ("d_model", None), **kw),
        "c_proj": pp.dense_init(ks[3], (d, G * N), ("d_model", None), **kw),
        "dt_proj": pp.dense_init(ks[4], (d, H), ("d_model", None), **kw),
        "conv_w": P(prng.normal_into(conv_w, ks[5], 0.1),
                    (None, "ssm_inner")),
        "A_log": P(a_log, (None,)),
        "D": pp.ones_init((H,), (None,), device=dev),
        "dt_bias": pp.zeros_init((H,), (None,), device=dev),
        "norm": pp.zeros_init((di,), ("ssm_inner",), device=dev),
        "out_proj": pp.dense_init(ks[6], (di, d), ("ssm_inner", "d_model"),
                                  **kw),
    }


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(u, w):
    """Depthwise causal conv: u (B, S, C), w (K, C) -> (B, S, C)."""
    K, S = w.shape[0], u.shape[1]
    out = torch.zeros_like(u)
    for i in range(K):
        shifted = F.pad(u, (0, 0, K - 1 - i, 0))[:, :S]
        out = out + shifted * w[i]
    return out


def _split_bcx(p: Dict, x, cfg, return_raw: bool = False, valid_len=None):
    """Project + conv. x (B,S,D) -> xs (B,S,H,P), Bm/Cm (B,S,G,N),
    dt (B,S,H), z (B,S,di).  dt is zeroed beyond valid_len (padded
    positions then neither decay nor update the state)."""
    B_, S, _ = x.shape
    di = cfg.ssm_d_inner
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, 1
    z = x @ p["z_proj"]
    xc = x @ p["x_proj"]
    bc = torch.cat([x @ p["b_proj"], x @ p["c_proj"]], dim=-1)
    u_raw = torch.cat([xc, bc], dim=-1)                 # (B,S,di+2GN)
    u = F.silu(_causal_conv(u_raw, p["conv_w"]))
    xc, bm, cm = torch.split(u, [di, G * N, G * N], dim=-1)
    dt = _softplus(x @ p["dt_proj"] + p["dt_bias"])     # (B,S,H)
    if valid_len is not None and valid_len < S:
        mask = (torch.arange(S, device=x.device) < valid_len).to(dt.dtype)
        dt = dt * mask[None, :, None]
    xs = xc.reshape(B_, S, H, Pd)
    bm = bm.reshape(B_, S, G, N)
    cm = cm.reshape(B_, S, G, N)
    if return_raw:
        return xs, bm, cm, dt, z, u_raw
    return xs, bm, cm, dt, z


def ssd_reference(xs, bm, cm, dt, A, D):
    """Naive O(S) recurrence oracle. xs (B,S,H,P), bm/cm (B,S,G,N),
    dt (B,S,H), A (H,) negative, D (H,).  Returns y (B,S,H,P) float32."""
    B_, S, H, Pd = xs.shape
    N = bm.shape[-1]
    xs32, bm32, cm32, dt32 = (t.float() for t in (xs, bm, cm, dt))
    h = torch.zeros((B_, H, Pd, N), device=xs.device)
    ys = []
    for t in range(S):
        a_t = torch.exp(dt32[:, t] * A)                      # (B,H)
        u = dt32[:, t, :, None, None] * torch.einsum(
            "bgn,bhp->bhpn", bm32[:, t], xs32[:, t])
        h = a_t[..., None, None] * h + u
        ys.append(torch.einsum("bhpn,bgn->bhp", h, cm32[:, t]))
    y = torch.stack(ys, dim=1)
    return y + xs32 * D[:, None]


def ssd_scan(xs, bm, cm, dt, A, D, chunk: int):
    """Chunked SSD. Same contract as ssd_reference; returns (y (B,S,H,P)
    float32, final state (B,H,P,N)).  S must be a multiple of ``chunk``.

    The reference's form, but for each chunk's end state: h_local =
    sum_s (exp(cum_end - cum_s) dt_s xs_s) ⊗ B_s, one batched product over
    the chunk's tokens, not a sum over a (B, C, Q, H, P, N) temporary."""
    B_, S, H, Pd = xs.shape
    N = bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_scan: {S} tokens are not chunks of {chunk} "
                         f"(pad the sequence to a chunk multiple)")
    C_ = S // chunk
    xs_c = xs.float().reshape(B_, C_, chunk, H, Pd)
    bm_c = bm.float().reshape(B_, C_, chunk, 1, N)
    cm_c = cm.float().reshape(B_, C_, chunk, 1, N)
    dt_c = dt.float().reshape(B_, C_, chunk, H)

    loga = dt_c * A                                     # (B,C,Q,H) log decay
    cum = torch.cumsum(loga, dim=2)                     # inclusive
    # intra-chunk quadratic term, M[t,s] = exp(cum[t]-cum[s]) for s<=t;
    # masked BEFORE the exp, or the masked entries' exp overflows
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,C,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xs.device))
    M = torch.exp(torch.where(tri[None, None, :, :, None], diff, -1e30))
    del diff
    cb = torch.einsum("bctgn,bcsgn->bcts", cm_c, bm_c)       # (B,C,t,s)
    G_ = cb[..., None] * M * dt_c[:, :, None, :, :]          # (B,C,t,s,H)
    del M
    y_intra = torch.einsum("bctsh,bcshp->bcthp", G_, xs_c)
    del G_

    # chunk-local end states and total decays
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,C,Q,H)
    xw = xs_c * (dec_to_end * dt_c)[..., None]               # (B,C,Q,H,P)
    h_local = torch.einsum("bcshp,bcsn->bchpn", xw, bm_c[:, :, :, 0])
    A_chunk = torch.exp(cum[:, :, -1, :])                    # (B,C,H)

    # inter-chunk state scan
    h = torch.zeros((B_, H, Pd, N), device=xs.device)
    h_prevs = []
    for c in range(C_):
        h_prevs.append(h)
        h = A_chunk[:, c, :, None, None] * h + h_local[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                     # (B,C,H,P,N)

    # inter-chunk contribution: C_t · (exp(cum[t]) * h_prev)
    y_inter = torch.einsum("bctgn,bchpn->bcthp", cm_c, h_prev) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B_, S, H, Pd)
    return y + xs.float() * D[:, None], h


def ssm_apply_with_state(p: Dict, x, cfg) -> Tuple[torch.Tensor, SSMState]:
    """Full block: x (B,S,D) -> ((B,S,D), SSMState) via chunked SSD.  A
    prompt that is not a multiple of the chunk is zero-padded, its padded
    positions' dt zeroed; the state (final h + conv tail) hands off to
    ``ssm_step``."""
    p = pp.cast_tree(p, x.dtype)
    S = x.shape[1]
    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    xs, bm, cm, dt, z, u_raw = _split_bcx(p, x, cfg, return_raw=True,
                                          valid_len=S)
    A = -torch.exp(p["A_log"])
    y, h_final = ssd_scan(xs, bm, cm, dt, A, p["D"], chunk)
    y = y.reshape(y.shape[0], y.shape[1], -1)               # (B,S,di)
    y = pp.rms_norm(y * F.silu(z.float()), p["norm"])
    out = y.to(x.dtype) @ p["out_proj"]
    # conv ring tail: last (conv) raw inputs, zero-padded on the left
    K = cfg.ssm_conv
    tail = u_raw[:, max(0, S - K):S]
    if tail.shape[1] < K:
        tail = F.pad(tail, (0, 0, K - tail.shape[1], 0))
    state = SSMState(h=h_final.reshape(h_final.shape[0], -1,
                                       h_final.shape[-1]), conv=tail)
    return (out[:, :S] if pad else out), state


def ssm_apply(p: Dict, x, cfg):
    """x (B,S,D) -> (B,S,D); state discarded (train path)."""
    return ssm_apply_with_state(p, x, cfg)[0]


def ssm_init_state(cfg, batch: int, dtype=torch.float32,
                   device=None) -> SSMState:
    G = 1
    dev = resolve_device(device)
    return SSMState(
        h=torch.zeros((batch, cfg.ssm_heads * cfg.ssm_head_dim,
                       cfg.ssm_state), device=dev),
        conv=torch.zeros((batch, cfg.ssm_conv,
                          cfg.ssm_d_inner + 2 * G * cfg.ssm_state),
                         dtype=dtype, device=dev))


def ssm_step(p: Dict, x, state: SSMState, cfg) -> Tuple[torch.Tensor,
                                                        SSMState]:
    """Single-token decode. x (B, 1, D) -> (y (B, 1, D), new state)."""
    p = pp.cast_tree(p, x.dtype)
    B_ = x.shape[0]
    di = cfg.ssm_d_inner
    H, Pd, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, 1
    xt = x[:, 0]
    z = xt @ p["z_proj"]
    u_new = torch.cat([xt @ p["x_proj"], xt @ p["b_proj"],
                       xt @ p["c_proj"]], dim=-1)
    conv = torch.cat([state.conv[:, 1:], u_new[:, None]], dim=1)  # promotes
    u = F.silu(torch.sum(conv * p["conv_w"][None], dim=1))
    xc, bm, cm = torch.split(u, [di, G * N, G * N], dim=-1)
    dt = _softplus(xt @ p["dt_proj"] + p["dt_bias"])       # (B,H)
    A = -torch.exp(p["A_log"])

    xs = xc.reshape(B_, H, Pd).float()
    bmr = bm.reshape(B_, G, N).float()
    cmr = cm.reshape(B_, G, N).float()
    a_t = torch.exp(dt.float() * A)                         # (B,H)
    upd = dt.float()[..., None, None] * torch.einsum("bgn,bhp->bhpn", bmr, xs)
    h = a_t[..., None, None] * state.h.reshape(B_, H, Pd, N) + upd
    y = torch.einsum("bhpn,bgn->bhp", h, cmr) + xs * p["D"][:, None]
    y = y.reshape(B_, di)
    y = pp.rms_norm(y * F.silu(z.float()), p["norm"])
    out = y.to(x.dtype) @ p["out_proj"]
    return out[:, None], SSMState(h=h.reshape(B_, H * Pd, N),
                                  conv=conv.to(state.conv.dtype))
