"""int8 gradient compression for a slow cross-pod link
(``repro.optim.compress``).

Per-chunk symmetric int8 quantization (chunks of ``CHUNK`` along the
flattened tensor, the last one zero-padded) with float32 scales; the
all-reduce moves ~4x fewer bytes.  ``ErrorFeedback`` re-injects each
step's local quantization residual into the next (Karimireddy et al.,
2019).

``compressed_psum(x, group)`` is the reference's ``compressed_psum(x,
axis_name)`` over a ``torch.distributed`` process group: the scales are
all-reduced with MAX, the requantized values as int32 with SUM.
``group=None`` is a world of one card, where both reductions are the
identity.  As in the reference, the trainer never calls these
(``TrainConfig.compress_pod_grads`` is declared and read nowhere).

Every float32 step is the reference's: ``torch.round`` rounds half to
even, as ``jnp.round``; divisors are tensors on the operand's device,
since on the GPU torch turns a division by a host scalar into a
multiplication by its reciprocal.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .adamw import tree_leaves, tree_map

CHUNK = 256


def _divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _pad_to_chunk(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat.reshape(-1, CHUNK), pad


def int8_compress(x: torch.Tensor):
    """x -> (int8 values (Nc, CHUNK), float32 scales (Nc, 1), pad)."""
    chunks, pad = _pad_to_chunk(x.to(torch.float32))
    scale = (torch.amax(torch.abs(chunks), dim=-1, keepdim=True)
             / _divisor(127.0, chunks))
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return q, scale, pad


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, pad: int, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _world(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def compressed_psum(x: torch.Tensor, group: Optional[Any] = None):
    """Quantize, sum as int32 over ``group`` (no overflow), dequantize.

    The scales are reduced with MAX, so every member dequantizes with one
    common scale (conservative; the residual goes to error feedback).  On
    the wire: 1 B a value and 4 B a chunk of 256 scales, ~1.016 B an
    element against 4 for a float32 sum."""
    q, scale, pad = int8_compress(x)
    common = scale.clone()
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(common, op=dist.ReduceOp.MAX, group=group)
    # requantize against the common scale so the integer sums agree
    requant = torch.clamp(torch.round(q.to(torch.float32) * scale / common),
                          -127, 127).to(torch.int32)
    if group is not None:
        dist.all_reduce(requant, op=dist.ReduceOp.SUM, group=group)
    return int8_decompress(requant, common, pad, x.shape)


class ErrorFeedback:
    """Residual accumulator: ``apply`` returns the compressed mean gradient
    and the new residuals (float32 trees shaped as the gradients)."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads)

    @staticmethod
    def apply(grads: Any, residual: Any, group: Optional[Any] = None):
        n = _world(group)
        outs, new_res = [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
            corrected = g.to(torch.float32) + r
            mean = compressed_psum(corrected, group) / _divisor(n, corrected)
            # error feedback tracks the *local* quantization error
            q, s, pad = int8_compress(corrected)
            local_deq = int8_decompress(q, s, pad, g.shape)
            outs.append(mean.to(g.dtype))
            new_res.append(corrected - local_deq)
        it_o, it_r = iter(outs), iter(new_res)
        return (tree_map(lambda _: next(it_o), grads),
                tree_map(lambda _: next(it_r), grads))
