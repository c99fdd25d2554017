"""Bit-packed table lookups (the gather primitive the march sits on).

Binary grids are bit-packed 32 cells per int32 into (rows, 128) tables,
so even a 256^3 occupancy grid is a 2 MB table. A lookup gathers the
128-word row holding the cell, then selects the word within the row with
a one-hot multiply + reduce and shifts out the bit.

This replaces the reference's per-thread ``grid_occupied_at`` byte loads
(``cuda/csrc/ray_marching.cu:27-45``). The row gather + lane select was
chosen for an earlier accelerator's gather costs; on the GPU a direct
gather of the bit word is the plain alternative, and which is faster is
for a profiled change to decide (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

LANES = 128
_WORD_BITS = 32
_ROW_BITS = LANES * _WORD_BITS  # 4096 grid cells per table row


def pack_bits(values: jnp.ndarray) -> jnp.ndarray:
    """Pack a boolean array into a (rows, 128) int32 bit-table.

    ``values`` is flattened; bit ``i`` lives at
    ``table[i >> 12, (i >> 5) & 127] >> (i & 31)``. The flat size is padded
    to a multiple of 4096 with zeros (reads past the end return False).
    """
    flat = values.reshape(-1).astype(bool)
    n = flat.shape[0]
    pad = (-n) % _ROW_BITS
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), bool)])
    words = flat.reshape(-1, _WORD_BITS).astype(jnp.uint32)
    shifts = jnp.asarray(np.arange(_WORD_BITS), jnp.uint32)
    packed = jnp.sum(words << shifts, axis=1, dtype=jnp.uint32)
    return packed.astype(jnp.int32).reshape(-1, LANES)


def bit_lookup(table: jnp.ndarray, flat_idx: jnp.ndarray) -> jnp.ndarray:
    """Read bits from a :func:`pack_bits` table at flat indices.

    Args:
        table: (rows, 128) int32 bit-table.
        flat_idx: (...,) int32 indices into the original flat boolean array.
            Must be in range (callers clamp; padded tail reads are False).

    Returns:
        (...,) bool.
    """
    shape = flat_idx.shape
    flat = flat_idx.reshape(-1).astype(jnp.int32)
    q = flat >> 12
    lane = (flat >> 5) & (LANES - 1)
    bit = flat & (_WORD_BITS - 1)
    rows = table[q]  # (N, 128) int32 row gather
    lanes = jnp.arange(LANES, dtype=jnp.int32)[None, :]
    word = jnp.sum(jnp.where(lanes == lane[:, None], rows, 0), axis=1)
    vals = (jnp.right_shift(word, bit) & 1).astype(bool)
    return vals.reshape(shape)


def row_lookup(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather full 128-lane rows: ``table[idx]``.

    Args:
        table: (rows, 128) any dtype.
        idx: (...,) int32 row indices.

    Returns:
        (..., 128).
    """
    shape = idx.shape
    return table[idx.reshape(-1)].reshape(*shape, table.shape[-1])


def lane_select(rows: jnp.ndarray, lane_idx: jnp.ndarray) -> jnp.ndarray:
    """Select one lane per row with a one-hot reduce (no gather).

    Args:
        rows: (N, 128).
        lane_idx: (N,) int32 in [0, 128).

    Returns:
        (N,) selected values.
    """
    lanes = jnp.arange(rows.shape[-1], dtype=jnp.int32)[None, :]
    if rows.dtype == jnp.bool_:
        return jnp.any((lanes == lane_idx[:, None]) & rows, axis=1)
    zero = jnp.zeros((), rows.dtype)
    return jnp.sum(jnp.where(lanes == lane_idx[:, None], rows, zero), axis=1)


def flat_lookup(values: jnp.ndarray, flat_idx: jnp.ndarray) -> jnp.ndarray:
    """Scalar lookup ``values.reshape(-1)[flat_idx]`` via the row fast path.

    ``values`` is any-shape; its flat size is padded to a multiple of 128.
    Use for float tables (e.g. EMA occupancies); for booleans prefer
    :func:`bit_lookup` (32x smaller table).
    """
    flat_vals = values.reshape(-1)
    n = flat_vals.shape[0]
    pad = (-n) % LANES
    if pad:
        flat_vals = jnp.concatenate(
            [flat_vals, jnp.zeros((pad,), flat_vals.dtype)]
        )
    table = flat_vals.reshape(-1, LANES)
    shape = flat_idx.shape
    flat = flat_idx.reshape(-1).astype(jnp.int32)
    rows = table[flat >> 7]
    return lane_select(rows, flat & (LANES - 1)).reshape(shape)
