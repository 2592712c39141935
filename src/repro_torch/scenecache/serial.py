"""Stable byte serialization for scene-block cache keys and entries
(``repro.scenecache.serial``; byte-identical to it, so the two packages
exchange entries).

The scenecache keys are already stable bytes (blake2b digests over
quantized ray geometry — key.py), which is what makes them shard
naturally across an external/multi-host store (ROADMAP).  This module
fixes the REST of the wire format: a versioned, endian-pinned byte
layout for the (key, coverage cell) pair and for a full cache entry
(key + cell + BlockOutput), so two processes — or a process and an
external key-value store — can exchange cached blocks without sharing
Python object state.

Layout rules (all integers little-endian, floats IEEE-754 f32 LE):

  key record    'SCK1' | u16 digest_len | digest
                | u16 scene_len | scene utf8 | u16 n_ints | n_ints * i64
  entry record  'SCE1' | key record | i64 chunks | u32 block_size
                | rgb f32[B*3] | acc f32[B] | depth f32[B]

The 4-byte magic carries the format version; bump it when the layout
changes — stale records must fail loudly (``ValueError``), never alias.
Host-side only, no device arrays cross this boundary.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from .store import BlockOutput

KEY_MAGIC = b"SCK1"
ENTRY_MAGIC = b"SCE1"

_F32 = np.dtype("<f4")
_I64 = np.dtype("<i8")


def key_to_bytes(key: bytes, cell: tuple) -> bytes:
    """Serialize a (digest, coverage cell) pair; stable across processes."""
    scene_id = cell[0]
    ints = [int(v) for v in cell[1:]]
    scene_b = scene_id.encode()
    return b"".join([
        KEY_MAGIC,
        struct.pack("<H", len(key)), key,
        struct.pack("<H", len(scene_b)), scene_b,
        struct.pack("<H", len(ints)),
        np.asarray(ints, _I64).tobytes(),
    ])


def key_from_bytes(buf: bytes) -> Tuple[bytes, tuple]:
    """Inverse of ``key_to_bytes``; raises ValueError on a foreign,
    stale-version, or truncated record."""
    try:
        key, cell, off = _read_key(buf, 0)
    except struct.error as e:
        # the documented contract is ValueError for ANY malformed record
        # — a header truncated mid-field must not leak struct.error
        raise ValueError(f"truncated key record: {e}") from e
    if off != len(buf):
        raise ValueError(f"trailing bytes after key record ({len(buf)-off})")
    return key, cell


def _read_key(buf: bytes, off: int):
    if buf[off:off + 4] != KEY_MAGIC:
        raise ValueError(f"not a scenecache key record "
                         f"(magic {buf[off:off + 4]!r} != {KEY_MAGIC!r})")
    off += 4
    (klen,) = struct.unpack_from("<H", buf, off)
    off += 2
    key = bytes(buf[off:off + klen])
    off += klen
    (slen,) = struct.unpack_from("<H", buf, off)
    off += 2
    scene_id = buf[off:off + slen].decode()
    off += slen
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    ints = np.frombuffer(buf, _I64, count=n, offset=off)
    off += n * 8
    return key, (scene_id, *(int(v) for v in ints)), off


def entry_to_bytes(key: bytes, cell: tuple, out: BlockOutput) -> bytes:
    """Serialize one finished block (key + cell + outputs)."""
    B = out.acc.shape[0]
    return b"".join([
        ENTRY_MAGIC,
        key_to_bytes(key, cell),
        struct.pack("<qI", int(out.chunks), B),
        np.ascontiguousarray(out.rgb, _F32).tobytes(),
        np.ascontiguousarray(out.acc, _F32).tobytes(),
        np.ascontiguousarray(out.depth, _F32).tobytes(),
    ])


def peek_entry_key(buf: bytes) -> bytes:
    """The key digest of a serialized entry WITHOUT decoding its arrays.

    The sharded store routes wire records by key bytes (sharded.py), so
    replication needs the key before it knows which shard's ``load_entry``
    should decode the record.  Raises ValueError like the full parsers.
    """
    if buf[:4] != ENTRY_MAGIC:
        raise ValueError(f"not a scenecache entry record "
                         f"(magic {buf[:4]!r} != {ENTRY_MAGIC!r})")
    try:
        key, _cell, _off = _read_key(buf, 4)
    except struct.error as e:
        raise ValueError(f"truncated entry record: {e}") from e
    return key


def entry_from_bytes(buf: bytes) -> Tuple[bytes, tuple, BlockOutput]:
    """Inverse of ``entry_to_bytes``.  The arrays are fresh host copies
    (the record buffer is not aliased)."""
    if buf[:4] != ENTRY_MAGIC:
        raise ValueError(f"not a scenecache entry record "
                         f"(magic {buf[:4]!r} != {ENTRY_MAGIC!r})")
    try:
        key, cell, off = _read_key(buf, 4)
        chunks, B = struct.unpack_from("<qI", buf, off)
    except struct.error as e:
        raise ValueError(f"truncated entry record: {e}") from e
    off += 12
    def take(n):
        nonlocal off
        a = np.frombuffer(buf, _F32, count=n, offset=off).copy()
        off += n * 4
        return a
    rgb = take(B * 3).reshape(B, 3)
    acc = take(B)
    depth = take(B)
    if off != len(buf):
        raise ValueError(f"trailing bytes after entry record "
                         f"({len(buf) - off})")
    return key, cell, BlockOutput(rgb, acc, depth, int(chunks))
