"""``jax.random``'s threefry2x32 in torch ops (``jax_threefry_partitionable``).

The reference draws every seeded number from ``jax.random`` with its
default threefry2x32 implementation, in the partitionable mode that jax
0.9 runs by default.  This module reproduces that scheme, so the port's
inits, training batches, probe jitter and sampled tokens are the
reference's for the same seed, and the same on every device:

* a key is a CPU int64 tensor of shape (2,) holding two uint32 words
  (``jax.random.key_data``); ``split`` gives (n, 2), whose rows are keys;
* ``PRNGKey(seed)`` is [0, seed mod 2^32] (the reference runs without x64,
  so a seed is an int32);
* draw i of a draw of n values hashes the counter (i >> 32, i & 0xFFFFFFFF)
  under the key; ``split(key, n)[i]`` and ``fold_in(key, i)`` are that
  hash's two words, ``bits`` their xor.

Keys are derived on the host.  The counters and everything after them are
made on the device the draw is for, as eager torch ops on int64 tensors
that hold uint32 values (uint32 lacks add and shifts in torch), so a draw
has the same bits on the CPU and the card.  ``uniform`` and ``randint``
equal ``jax.random``'s bit for bit, and so do ``normal`` and
``categorical``, whose float32 functions are the ones the reference's XLA
runs on the CPU, op for op: ``erf_inv`` is XLA's expansion (Giles'
polynomial, a correctly rounded sqrt), and ``log`` / ``log1p`` are XLA's
compiled Cephes functions, their multiply-adds fused as XLA's are
(``xla_log``, ``xla_log1p``).  ``xla_exp``, XLA's Cephes exp, serves the
MoE router's softmax (``models.ffn.softmax_f32``).  Nothing here is
compiled: ``uniform``'s multiply and add must stay two roundings, as
XLA's are.

Draws of more than ``CHUNK`` values are made ``CHUNK`` counters at a time
into their output, so the int64 temporaries stay small however large the
draw (gemma2-27b's 1.18e9-value embedding); the values do not depend on
the chunking.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 25                  # counters hashed at a time by a draw
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's float32 erf_inv (Giles): coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's CPU float32 log and log1p (Cephes logf / log1pf), as float32 values
_TINY = float(np.finfo(np.float32).tiny)
_LOG_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
_LOG1P_DEN = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
              309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_NUM = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
              29.91191864013672, 60.949668884277344, 57.112964630126953,
              20.039552688598633)
_LOG1P_SMALL = 0.4142135679721832
# XLA's CPU float32 exp (Cephes expf)
_EXP_LO, _EXP_HI = -88.3762626647949, 88.3762626647950
_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = 0.693359375, -2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in double)."""
    return float(np.float32(x))


def _threefry(k0: int, k1: int, x0: torch.Tensor,
              x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32 of the counter words (x0, x1) (int64 tensors of uint32
    values) under the key (k0, k1); returns the two output words.  x0 is
    reduced mod 2^32 only at the end: its low 32 bits are exact, and they
    are all that reaches x1 before x1 is reduced."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            rot = torch.bitwise_left_shift(x1, r)
            x1 >>= 32 - r
            x1 |= rot
            x1 ^= x0
            x1 &= MASK
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + i + 1
        x1 &= MASK
    return x0 & MASK, x1


def _key_words(key) -> Tuple[int, int]:
    k = torch.as_tensor(key).reshape(-1)
    if k.numel() != 2:
        raise ValueError(f"a key is two uint32 words, got shape "
                         f"{tuple(torch.as_tensor(key).shape)}")
    return int(k[0]), int(k[1])


def _hash_counters(key, start: int, stop: int, device):
    """Both output words of the counters start .. stop-1 (flat indices)."""
    k0, k1 = _key_words(key)
    c = torch.arange(start, stop, dtype=torch.int64, device=device)
    return _threefry(k0, k1, c >> 32, c & MASK)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: [0, seed mod 2^32]."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, row i the hash of counter i."""
    w0, w1 = _hash_counters(key, 0, num, "cpu")
    return torch.stack([w0, w1], dim=-1)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counter ``data`` (mod 2^32)."""
    w0, w1 = _hash_counters(key, int(data) & MASK, (int(data) & MASK) + 1,
                            "cpu")
    return torch.stack([w0, w1], dim=-1)[0]


def _fill(out: torch.Tensor, fn, key) -> torch.Tensor:
    """Write fn(bits of counters a .. b-1) into out's flat [a, b), CHUNK
    counters at a time; ``out`` is contiguous.  A meta tensor (a shape
    without storage) is left as it is."""
    if out.device.type == "meta":
        return out
    flat = out.view(-1)
    for a in range(0, flat.numel(), CHUNK):
        b = min(flat.numel(), a + CHUNK)
        w0, w1 = _hash_counters(key, a, b, out.device)
        w0 ^= w1
        flat[a:b] = fn(w0)
    return out


def bits(key, shape: Sequence[int] = (), device=None) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values in an int64 tensor."""
    out = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    return _fill(out, lambda b: b, key)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """Bits -> float32 in [0, 1): 23 mantissa bits under exponent 0, less 1."""
    return (((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
            - 1.0)


def _uniform_fn(minval: float, maxval: float):
    lo, span = _f32(minval), _f32(np.float32(maxval) - np.float32(minval))

    def fn(b):
        u = _unit_floats(b) * span      # two roundings, as XLA's
        u += lo
        return torch.clamp_min(u, lo)
    return fn


def uniform(key, shape: Sequence[int] = (), dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: [minval, maxval)."""
    if dtype != torch.float32:
        raise ValueError(f"uniform: float32 only, got {dtype}")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return _fill(out, _uniform_fn(minval, maxval), key)


def _mul_mod32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for uint32 values ``a`` and a uint32 ``m``, in
    int64 without overflow (m split into 16-bit halves)."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key, shape: Sequence[int], minval: int, maxval: int,
            dtype=torch.int32, device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: two words of bits a value,
    (hi % span * (2^32 % span) + lo % span) % span in uint32 arithmetic."""
    if dtype != torch.int32:
        raise ValueError(f"randint: int32 only, got {dtype}")
    minval, maxval = int(minval), int(maxval)
    if not (-2**31 <= minval < 2**31 and -2**31 <= maxval < 2**31):
        raise ValueError("randint: int32 bounds")
    k_hi, k_lo = split(key)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span      # the square wraps in uint32
    hi = bits(k_hi, shape, device)
    lo = bits(k_lo, shape, device)
    off = (_mul_mod32(hi % span, mult) + lo % span) & MASK
    off %= span
    v = (off + minval) & MASK
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (through float64, where a * b is
    exact), as the FMA of XLA's compiled math functions."""
    return (a.double() * b + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log, op for op (Cephes logf, with the fused
    multiply-adds XLA's compiled function has): x = m 2^e with m in
    [sqrt(1/2), sqrt(2)), a polynomial in m - 1, e ln 2 in two parts;
    -inf at 0 and for denormals (read as zero), NaN below 0, +inf at
    +inf."""
    v = torch.clamp_min(x, _TINY)
    b = v.view(torch.int32)
    e = ((b >> 23) - 127).to(torch.float32) + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _LOG_SQRTHF
    e = e - lt.to(torch.float32)
    f = (m - 1.0) + torch.where(lt, m, 0.0)
    z = f * f
    z3 = z * f
    p1 = _fma(_fma(f, _LOG_P[0], _LOG_P[1]), f, _LOG_P[2])
    p2 = _fma(_fma(f, _LOG_P[3], _LOG_P[4]), f, _LOG_P[5])
    p3 = _fma(_fma(f, _LOG_P[6], _LOG_P[7]), f, _LOG_P[8])
    t = _fma(_fma(_fma(p1, z3, p2), z3, p3), z3, e * _LOG_Q1)
    # z * 0.5 and e * ln2's high part are exact: no FMA can change them
    r = (f - z * 0.5) + t + e * _LOG_Q2
    r = torch.where(x > 0.0, r, math.nan)
    r = torch.where(x.abs() < _TINY, -math.inf, r)
    return torch.where(x == math.inf, math.inf, r)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 exp, op for op (Cephes expf, with the fused
    multiply-adds XLA's compiled function has): x clamped, n = floor(x
    log2(e) + 1/2), r = x - n ln 2 in two parts, a degree-5 polynomial,
    times 2^n; denormal results read as 0."""
    x = torch.clamp(x, _f32(_EXP_LO), _f32(_EXP_HI))
    n = torch.floor(_fma(x, _f32(_LOG2E), 0.5))
    r = _fma(n, -_f32(_EXP_C1), x)
    r = _fma(n, -_f32(_EXP_C2), r)
    y = _fma(r, _f32(_EXP_P[0]), _f32(_EXP_P[1]))
    for c in _EXP_P[2:]:
        y = _fma(y, r, _f32(c))
    y = 1.0 + _fma(y, r * r, r)
    out = y * ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.where(out < _TINY, 0.0, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log1p, op for op: Cephes' rational approximation
    for |x| < sqrt(2) - 1, ``xla_log(x + 1)`` beyond; 0 for denormals."""
    x2 = x * x
    den = torch.full_like(x, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = den * x + c
    num = torch.full_like(x, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = num * x + c
    small = x2 * -0.5 + (x * x2) * (num / den)
    small = x + small
    r = torch.where(x.abs() < _LOG1P_SMALL, small, xla_log(x + 1.0))
    return torch.where(x.abs() < _TINY, x * 0.0, r)    # denormals read as 0


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv, op for op: w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at +-1."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    # float32 sqrt correctly rounded, as XLA's (torch's CPU sqrt is not)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, _f32(c_lt), _f32(c_ge)) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal_fn(scale):
    lo = _f32(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    uni, root2 = _uniform_fn(lo, 1.0), _f32(np.sqrt(2.0))

    def fn(b):
        z = erf_inv(uni(b)) * root2
        return z if scale is None else z * _f32(scale)
    return fn


def normal(key, shape: Sequence[int] = (), dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(uniform(key,
    (nextafter(-1, 0), 1)))."""
    if dtype != torch.float32:
        raise ValueError(f"normal: float32 only, got {dtype}")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return _fill(out, _normal_fn(None), key)


def normal_into(out: torch.Tensor, key, scale: float) -> torch.Tensor:
    """``out`` <- (normal(key, out.shape) * float32(scale)) cast to out's
    dtype: the float32 draw and product as the reference forms them,
    made a chunk at a time into a contiguous tensor of any float dtype."""
    if not out.is_contiguous():
        raise ValueError("normal_into: a contiguous output")
    return _fill(out, _normal_fn(scale), key)


def gumbel(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", the default) in float32:
    -log(-log(uniform(key, (tiny, 1))))."""
    uni = _uniform_fn(_TINY, 1.0)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return _fill(out, lambda b: -xla_log(-xla_log(uni(b))), key)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: argmax over ``axis`` of
    float32 ``logits`` plus Gumbel noise drawn over logits' shape (the first
    maximum on a tie, as both frameworks' argmax).  int64 indices."""
    if logits.dtype != torch.float32:
        raise ValueError(f"categorical: float32 logits, got {logits.dtype}")
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits, dim=axis)
