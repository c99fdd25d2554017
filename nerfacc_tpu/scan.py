"""Segmented scans over packed per-ray sample buffers (the keystone op).

The reference accelerates its packed layout two ways: per-ray serial CUDA
loops ("naive") and CUB ``DeviceScan::Exclusive{Sum,Scan}ByKey`` keyed by
``ray_indices`` ("CUB", ``cuda/csrc/render_transmittance_cub.cu:19-37``).
The CUB formulation is the XLA-native one: a segmented exclusive scan is
two global cumsums plus one segment-sum, all of which XLA compiles to
parallel scans. There is no naive/CUB duality here — one
implementation serves both entry points.

Layout contract (everywhere in this package):
  * packed arrays are flat ``(n_samples,)`` with samples of the same ray
    contiguous and rays in ascending order (``ray_indices`` sorted);
  * invalid (padding) entries must carry ``x == 0`` — they then cannot
    perturb any scan result;
  * ``n_rays`` is static (Python int).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum(x: jnp.ndarray, seg_ids: jnp.ndarray, num_segments: int) -> jnp.ndarray:
    """Sum ``x`` per segment. seg_ids must be sorted ascending."""
    return jax.ops.segment_sum(
        x, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )


def exclusive_segment_cumsum(
    x: jnp.ndarray, seg_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    """Exclusive cumulative sum within each segment.

    Equivalent of CUB ``ExclusiveSumByKey``
    (``render_transmittance_cub.cu:19-26``): result[i] = sum of x[j] for all
    j < i in the same segment. Requires sorted ``seg_ids`` — guaranteed by
    this package's packed layout.

    Implementation: the classic segmented-scan reset operator under
    ``lax.associative_scan`` (same pattern as
    :func:`exclusive_segment_cumprod`). An earlier formulation (global
    cumsum minus per-segment offsets) matched CUB only to ~2e-2 absolute at
    bench-scale buffers: the subtraction cancels two terms that grow with
    the *global* prefix, so late rays lose up to half the mantissa. The
    reset operator never accumulates across a segment boundary — error per
    element is eps-scaled to the segment partial sum, exactly like the
    reference's per-ray serial loop.
    """
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)
    xa = x.astype(acc_dtype)
    n = xa.shape[0]
    idx = jnp.arange(n)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), seg_ids[1:] != seg_ids[:-1]]
    )
    # shift within segment: v'_i = x_{i-1}, segment starts get identity 0;
    # then an *inclusive* segmented sum of v' is the exclusive one of x.
    shifted = jnp.where(first, 0.0, xa[jnp.maximum(idx - 1, 0)])

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va + vb)

    _, out = jax.lax.associative_scan(combine, (first, shifted))
    return out.astype(x.dtype)


def inclusive_segment_cumsum(
    x: jnp.ndarray, seg_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    """Inclusive per-segment cumulative sum."""
    return exclusive_segment_cumsum(x, seg_ids, num_segments) + x


def reverse_exclusive_segment_cumsum(
    x: jnp.ndarray, seg_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    """Exclusive suffix sum within each segment.

    Equivalent of the reference backward passes' reverse scans
    (``render_transmittance_cub.cu:99-103``): result[i] = sum of x[j] for
    j > i in the same segment. Computed as total - inclusive prefix.
    """
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)
    xa = x.astype(acc_dtype)
    incl = exclusive_segment_cumsum(xa, seg_ids, num_segments) + xa
    totals = segment_sum(xa, seg_ids, num_segments)
    out = totals[jnp.clip(seg_ids, 0, num_segments - 1)] - incl
    return out.astype(x.dtype)


def exclusive_segment_cumprod(
    x: jnp.ndarray, seg_ids: jnp.ndarray, num_segments: int
) -> jnp.ndarray:
    """Exclusive per-segment cumulative product.

    Equivalent of CUB ``ExclusiveProductByKey``
    (``render_transmittance_cub.cu:28-37``) used for
    transmittance-from-alpha. Implemented with the classic segmented-scan
    operator under ``lax.associative_scan`` — exact products (no log/exp
    roundtrip), parallel.
    """
    acc_dtype = jnp.promote_types(x.dtype, jnp.float32)
    xa = x.astype(acc_dtype)
    n = xa.shape[0]
    idx = jnp.arange(n)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), seg_ids[1:] != seg_ids[:-1]]
    )
    # shift within segment: v'_i = x_{i-1}, segment starts get identity 1;
    # then an *inclusive* segmented product of v' is the exclusive one of x.
    shifted = jnp.where(
        first, 1.0, xa[jnp.maximum(idx - 1, 0)]
    )

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va * vb)

    _, prod = jax.lax.associative_scan(combine, (first, shifted))
    return prod.astype(x.dtype)
