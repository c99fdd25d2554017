"""Packed <-> dense sample-layout conversions (static shapes).

The reference stores variable-length per-ray samples in flat buffers plus
either ``ray_indices`` (sample -> ray) or ``packed_info`` (per-ray
``[start, count]``); see reference ``nerfacc/pack.py`` and
``cuda/csrc/pack.cu``. The CUDA version allocates exact-size outputs after
a device->host sync. XLA requires static shapes, so this package uses
**fixed-capacity** buffers everywhere: packed arrays have a caller-chosen
static length and a boolean validity mask; dense arrays have a static
``n_samples`` per-ray capacity and a mask.

All functions are jit-compatible; capacities are Python ints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .scan import segment_sum


def pack_info(
    ray_indices: jnp.ndarray,
    n_rays: int,
    masks: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Convert ``ray_indices`` to ``packed_info`` (reference ``pack.py:46-77``).

    Args:
        ray_indices: (n_samples,) sorted ray index of each sample.
        n_rays: static number of rays.
        masks: optional (n_samples,) validity; invalid samples are not
            counted.

    Returns:
        (n_rays, 2) int32 ``[start, count]`` per ray. ``start`` is the index
        of the ray's first sample in the packed buffer (cumsum convention,
        identical to the reference).
    """
    ones = jnp.ones_like(ray_indices, dtype=jnp.int32)
    if masks is not None:
        ones = jnp.where(masks, ones, 0)
    num_steps = segment_sum(ones, ray_indices, n_rays)
    cum_steps = jnp.cumsum(num_steps)
    return jnp.stack([cum_steps - num_steps, num_steps], axis=-1)


def unpack_info(packed_info: jnp.ndarray, n_samples: int) -> jnp.ndarray:
    """Convert ``packed_info`` to ``ray_indices`` (reference ``pack.py:80-121``).

    Samples not covered by any ray (padding tail beyond the last ray's
    samples) get index ``n_rays - 1`` — callers using fixed-capacity buffers
    track validity with a mask, not with sentinel indices.

    Args:
        packed_info: (n_rays, 2) ``[start, count]``.
        n_samples: static packed-buffer length.

    Returns:
        (n_samples,) int32 ray index per sample.
    """
    n_rays = packed_info.shape[0]
    starts = packed_info[:, 0]
    counts = packed_info[:, 1]
    # Scatter (ray_id + 1) at each non-empty ray's first sample, then
    # forward-fill with a running max. Empty rays scatter nothing; when
    # several rays share a start position the largest id (the live one)
    # wins. Works for contiguous and gapped packed layouts alike.
    ids = jnp.arange(n_rays, dtype=jnp.int32) + 1
    safe_starts = jnp.where(counts > 0, starts, n_samples)
    marks = jnp.zeros((n_samples + 1,), dtype=jnp.int32).at[safe_starts].max(ids)
    ray_ids = jax.lax.cummax(marks[:-1]) - 1
    return jnp.clip(ray_ids, 0, n_rays - 1).astype(jnp.int32)


def unpack_info_to_mask(
    packed_info: jnp.ndarray, n_samples: int
) -> jnp.ndarray:
    """Dense (n_rays, n_samples) mask from ``packed_info``
    (reference ``pack.cu:30-52``)."""
    counts = packed_info[:, 1]
    cols = jnp.arange(n_samples, dtype=jnp.int32)[None, :]
    return cols < counts[:, None]


def pack_data(
    data: jnp.ndarray,
    mask: jnp.ndarray,
    n_samples: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack dense (n_rays, S, D) data into a flat fixed-capacity buffer.

    Static-shape redesign of reference ``pack.py:12-43``: the output
    length is the static capacity ``n_samples`` (default ``n_rays * S``)
    instead of the dynamic ``mask.sum()``; a validity mask is returned
    alongside.

    Args:
        data: (n_rays, S, D).
        mask: (n_rays, S) bool.
        n_samples: static output capacity.

    Returns:
        (packed_data (n_samples, D), packed_info (n_rays, 2),
        valid (n_samples,) bool). Padding rows of ``packed_data`` are zero.
    """
    n_rays, S, D = data.shape
    total = n_rays * S
    if n_samples is None:
        n_samples = total
    flat_mask = mask.reshape(-1)
    (sel,) = jnp.nonzero(flat_mask, size=n_samples, fill_value=total)
    valid = sel < total
    sel_c = jnp.minimum(sel, total - 1)
    packed = jnp.where(
        valid[:, None], data.reshape(total, D)[sel_c], 0.0
    )
    counts = mask.sum(axis=-1).astype(jnp.int32)
    cum = jnp.cumsum(counts)
    packed_info = jnp.stack([cum - counts, counts], axis=-1)
    return packed, packed_info, valid


def unpack_data(
    packed_info: jnp.ndarray,
    data: jnp.ndarray,
    n_samples: int,
) -> jnp.ndarray:
    """Unpack flat (N, D) data to dense (n_rays, n_samples, D), zero-padded.

    Differentiable in ``data`` (gradient is the masked gather transpose —
    XLA derives it; matches reference ``pack.py:170-190``).

    Args:
        packed_info: (n_rays, 2) ``[start, count]``.
        data: (N, D) packed samples.
        n_samples: static per-ray capacity of the dense output.
    """
    N = data.shape[0]
    starts = packed_info[:, 0]
    counts = packed_info[:, 1]
    cols = jnp.arange(n_samples, dtype=jnp.int32)[None, :]
    idx = starts[:, None] + cols  # (n_rays, n_samples)
    valid = cols < counts[:, None]
    idx_c = jnp.clip(idx, 0, N - 1)
    dense = data[idx_c]  # (n_rays, n_samples, D)
    return jnp.where(valid[..., None], dense, 0.0)
