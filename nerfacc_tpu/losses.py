"""Losses.

Distortion loss (MipNeRF-360 Eq. 15). The reference materializes a dense
(n_rays, S, S) pairwise matrix (``nerfacc/losses.py:6-32``, O(S^2) memory
and FLOPs); since sample midpoints are sorted along each ray, the pairwise
term collapses to an O(S) segmented-scan form:

    sum_ij w_i w_j |m_i - m_j| = 2 * sum_i w_i * (m_i * A_i - B_i),
        A_i = sum_{j<i} w_j,   B_i = sum_{j<i} w_j m_j.

This is both asymptotically cheaper and a better fit for XLA (two
segmented prefix sums instead of a batched outer product).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from .pack import unpack_info
from .scan import exclusive_segment_cumsum, segment_sum
from .vol_rendering import _flatten


def distortion(
    packed_info: Optional[jnp.ndarray],
    weights: jnp.ndarray,
    t_starts: jnp.ndarray,
    t_ends: jnp.ndarray,
    *,
    ray_indices: Optional[jnp.ndarray] = None,
    n_rays: Optional[int] = None,
    masks: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Distortion loss per ray (reference ``losses.py:6-32``).

    Requires sample midpoints sorted ascending within each ray (always true
    for marching outputs). Differentiable in ``weights``.

    Args:
        packed_info: (n_rays, 2) or None (then pass ``ray_indices``+``n_rays``).
        weights: (all_samples,) rendering weights.
        t_starts / t_ends: (all_samples, 1) or (all_samples,).
        masks: optional validity mask for fixed-capacity buffers.

    Returns:
        (n_rays,) loss values.
    """
    from .vol_rendering import _detect_dense_layout

    w, _ = _flatten(weights)
    ts, _ = _flatten(t_starts)
    te, _ = _flatten(t_ends)
    dl = _detect_dense_layout(ray_indices, packed_info, w.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        return distortion_dense(
            w.reshape(R, K), ts.reshape(R, K), te.reshape(R, K), masks=m2
        )
    if ray_indices is None:
        assert packed_info is not None
        ray_indices = unpack_info(packed_info, w.shape[0])
        n_rays = packed_info.shape[0]
    ray_indices = ray_indices.astype(jnp.int32)
    if n_rays is None:
        n_rays = w.shape[0]
    if masks is not None:
        m, _ = _flatten(masks)
        w = jnp.where(m, w, 0.0)

    interval = te - ts
    tmid = (ts + te) / 2.0

    loss_uni = (1.0 / 3.0) * segment_sum(interval * w * w, ray_indices, n_rays)
    A = exclusive_segment_cumsum(w, ray_indices, n_rays)
    B = exclusive_segment_cumsum(w * tmid, ray_indices, n_rays)
    loss_bi = 2.0 * segment_sum(w * (tmid * A - B), ray_indices, n_rays)
    return loss_uni + loss_bi


def distortion_dense(
    weights: jnp.ndarray,
    t_starts: jnp.ndarray,
    t_ends: jnp.ndarray,
    masks: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Distortion loss on the dense (n_rays, K) layout — the row-cumsum
    twin of :func:`distortion` (same O(K) scan form).

    Returns:
        (n_rays,) loss values; differentiable in ``weights``.
    """
    w = weights
    if masks is not None:
        w = jnp.where(masks, w, 0.0)
    interval = t_ends - t_starts
    tmid = (t_starts + t_ends) / 2.0
    loss_uni = (1.0 / 3.0) * jnp.sum(interval * w * w, axis=1)
    wa = jnp.cumsum(w, axis=1) - w  # exclusive
    wb = jnp.cumsum(w * tmid, axis=1) - w * tmid
    loss_bi = 2.0 * jnp.sum(w * (tmid * wa - wb), axis=1)
    return loss_uni + loss_bi
