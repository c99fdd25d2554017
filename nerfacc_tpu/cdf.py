"""CDF importance resampling.

Redesign of the reference's per-ray two-pointer merge kernel
(``cuda/csrc/cdf.cu:7-77``) as a vectorized searchsorted over a *global*
monotone CDF: each ray's in-segment inclusive CDF (in (0, 1]) is offset by
its ray index, making one flat sorted array; the per-ray uniform targets are
offset the same way, and a single ``searchsorted`` resolves every query at
once. Semantics (weight padding ``max(1e-5 - sum w, 0)`` spread uniformly,
bin targets ``u_j = 1/(2 * num_bins) + j * (1 - 1/num_bins)/steps``) match
the reference exactly; rays with zero samples produce zero resamples
(``cdf.cu:36-47,177``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from .pack import unpack_info
from .scan import exclusive_segment_cumsum, segment_sum
from .vol_rendering import _flatten


class ResampledRays(NamedTuple):
    """Fixed-capacity resampling output: ray r owns slots
    ``[r * n_samples, (r+1) * n_samples)``."""

    packed_info: jnp.ndarray  # (n_rays, 2): [r * n, n or 0]
    t_starts: jnp.ndarray  # (n_rays * n, 1)
    t_ends: jnp.ndarray  # (n_rays * n, 1)
    masks: jnp.ndarray  # (n_rays * n,) bool
    ray_indices: jnp.ndarray  # (n_rays * n,) int32


def ray_resampling(
    packed_info: Optional[jnp.ndarray],
    t_starts: jnp.ndarray,
    t_ends: jnp.ndarray,
    weights: jnp.ndarray,
    n_samples: int,
    *,
    ray_indices: Optional[jnp.ndarray] = None,
    n_rays: Optional[int] = None,
    masks: Optional[jnp.ndarray] = None,
) -> ResampledRays:
    """Resample ``n_samples`` intervals per ray uniformly in the weight CDF
    (reference ``cdf.py:12-46`` / ``cdf.cu``).

    Args:
        packed_info: (n_rays, 2), or None with ``ray_indices`` + ``n_rays``.
        t_starts / t_ends: (N, 1) packed input intervals.
        weights: (N,) per-sample rendering weights (non-negative).
        n_samples: static resample count per ray.
        masks: optional validity for fixed-capacity inputs.

    Returns:
        :class:`ResampledRays`; rays with zero input samples are masked out.
    """
    from .vol_rendering import _detect_dense_layout

    w, _ = _flatten(weights)
    ts, _ = _flatten(t_starts)
    te, _ = _flatten(t_ends)
    N = w.shape[0]
    dl = _detect_dense_layout(ray_indices, packed_info, N, n_rays)
    if dl is not None:
        # dense bridge: ray-major fixed-K layout -> row-op twin (same
        # semantics as the flat global-searchsorted path)
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        s2, e2, mk2 = ray_resampling_dense(
            ts.reshape(R, K), te.reshape(R, K), w.reshape(R, K),
            n_samples, masks=m2,
        )
        alive = mk2[:, 0]
        out_info = jnp.stack(
            [
                jnp.arange(R, dtype=jnp.int32) * n_samples,
                jnp.where(alive, n_samples, 0).astype(jnp.int32),
            ],
            axis=-1,
        )
        return ResampledRays(
            out_info,
            s2.reshape(-1, 1),
            e2.reshape(-1, 1),
            mk2.reshape(-1),
            jnp.repeat(jnp.arange(R, dtype=jnp.int32), n_samples),
        )
    if ray_indices is None:
        assert packed_info is not None
        ray_indices = unpack_info(packed_info, N)
        n_rays = packed_info.shape[0]
    seg = ray_indices.astype(jnp.int32)
    assert n_rays is not None, "n_rays must be static"

    if masks is not None:
        m, _ = _flatten(masks)
    else:
        m = jnp.ones((N,), dtype=bool)
    w = jnp.where(m, jnp.maximum(w, 0.0), 0.0)

    counts = segment_sum(m.astype(jnp.int32), seg, n_rays)  # (n_rays,)
    w_sum = segment_sum(w, seg, n_rays)
    padding = jnp.maximum(1e-5 - w_sum, 0.0)
    padding_step = jnp.where(counts > 0, padding / jnp.maximum(counts, 1), 0.0)
    w_pad = jnp.where(m, w + padding_step[seg], 0.0)
    denom = jnp.maximum(w_sum + padding, 1e-20)
    w_norm = w_pad / denom[seg]

    # Global monotone CDF: ray r occupies (r, r+1]. Masked entries carry
    # w_norm == 0, so the inclusive cumsum repeats the previous value across
    # them — the array stays sorted with interior holes, and a left-search
    # always resolves to the first *valid* entry reaching the target (any
    # duplicate-valued masked entry sits after the valid one carrying the
    # same value).
    cdf_incl = exclusive_segment_cumsum(w_norm, seg, n_rays) + w_norm
    g = seg.astype(jnp.float32) + cdf_incl

    # per-ray bin-boundary targets (cdf.cu:42-47)
    num_bins = n_samples + 1
    cdf_step = (1.0 - 1.0 / num_bins) / n_samples
    u = 1.0 / (2 * num_bins) + jnp.arange(num_bins, dtype=jnp.float32) * cdf_step
    rid = jnp.arange(n_rays, dtype=jnp.float32)[:, None]
    qg = (rid + u[None, :]).reshape(-1)  # (n_rays * num_bins,)

    # Clamp each query's hit into its own ray's slot range: the global CDF
    # relies on f32 ``ray_index + cdf`` staying ordered, but at large n_rays
    # the f32 ulp near the ray offset approaches the bin spacing, so a seam
    # query could otherwise resolve into a neighboring ray's segment.
    full_counts = segment_sum(jnp.ones_like(seg), seg, n_rays)
    seg_end = jnp.cumsum(full_counts)  # exclusive end of ray r's slots
    seg_lo = seg_end - full_counts
    qr = jnp.repeat(jnp.arange(n_rays, dtype=jnp.int32), num_bins)
    idx = jnp.searchsorted(g, qg, side="left")
    idx = jnp.clip(idx, seg_lo[qr], jnp.maximum(seg_end[qr] - 1, seg_lo[qr]))
    idx = jnp.clip(idx, 0, N - 1)
    cdf_next = cdf_incl[idx]
    prev_i = jnp.maximum(idx - 1, 0)
    prev_same_ray = (idx > 0) & (seg[prev_i] == seg[idx])
    cdf_prev = jnp.where(prev_same_ray, cdf_incl[prev_i], 0.0)
    scaling = (te[idx] - ts[idx]) / jnp.maximum(cdf_next - cdf_prev, 1e-20)
    u_flat = jnp.broadcast_to(u[None, :], (n_rays, num_bins)).reshape(-1)
    t = (u_flat - cdf_prev) * scaling + ts[idx]  # (n_rays * num_bins,)

    bounds = t.reshape(n_rays, num_bins)
    alive = counts > 0
    out_starts = jnp.where(alive[:, None], bounds[:, :-1], 0.0).reshape(-1, 1)
    out_ends = jnp.where(alive[:, None], bounds[:, 1:], 0.0).reshape(-1, 1)
    out_masks = jnp.broadcast_to(alive[:, None], (n_rays, n_samples)).reshape(-1)
    out_ray_indices = jnp.repeat(
        jnp.arange(n_rays, dtype=jnp.int32), n_samples
    )
    out_counts = jnp.where(alive, n_samples, 0).astype(jnp.int32)
    out_info = jnp.stack(
        [jnp.arange(n_rays, dtype=jnp.int32) * n_samples, out_counts], axis=-1
    )
    return ResampledRays(out_info, out_starts, out_ends, out_masks, out_ray_indices)


def ray_resampling_dense(
    t_starts: jnp.ndarray,
    t_ends: jnp.ndarray,
    weights: jnp.ndarray,
    n_samples: int,
    masks: Optional[jnp.ndarray] = None,
):
    """Dense-layout CDF resampling: (n_rays, K) in, (n_rays, n_samples) out.

    Same semantics as :func:`ray_resampling` (weight padding, bin targets,
    zero-sample rays masked out) but one ray per row: the inverse-CDF
    lookup is a dense rank reduce ``sum_k (cdf[r,k] < u[r,b])`` — no
    searchsorted, no gathers beyond a per-row one-hot select.

    Returns:
        (t_starts, t_ends, masks) of shapes (n_rays, n_samples) x2 + bool.
    """
    R, K = weights.shape
    if masks is None:
        masks = jnp.ones((R, K), bool)
    w = jnp.where(masks, jnp.maximum(weights, 0.0), 0.0)
    counts = masks.sum(axis=1)  # (R,)
    w_sum = w.sum(axis=1, keepdims=True)
    padding = jnp.maximum(1e-5 - w_sum, 0.0)
    pad_step = jnp.where(
        counts[:, None] > 0, padding / jnp.maximum(counts[:, None], 1), 0.0
    )
    w = jnp.where(masks, w + pad_step, 0.0)
    denom = jnp.maximum(w.sum(axis=1, keepdims=True), 1e-20)
    w_norm = w / denom
    cdf = jnp.cumsum(w_norm, axis=1)  # inclusive, (R, K), last == 1

    num_bins = n_samples + 1
    cdf_step = (1.0 - 1.0 / num_bins) / n_samples
    u = 1.0 / (2 * num_bins) + jnp.arange(num_bins, dtype=jnp.float32) * cdf_step

    # idx[r, b] = first k with cdf[r, k] >= u[b]  (dense rank reduce)
    idx = jnp.sum(
        cdf[:, :, None] < u[None, None, :], axis=1, dtype=jnp.int32
    )  # (R, num_bins)
    idx = jnp.minimum(idx, K - 1)

    from .ray_marching import gather_rows_dense

    cdf_next = gather_rows_dense(cdf, idx)
    cdf_prev = jnp.where(
        idx > 0, gather_rows_dense(cdf, jnp.maximum(idx - 1, 0)), 0.0
    )
    ts_sel = gather_rows_dense(t_starts, idx)
    te_sel = gather_rows_dense(t_ends, idx)
    scaling = (te_sel - ts_sel) / jnp.maximum(cdf_next - cdf_prev, 1e-20)
    bounds = (u[None, :] - cdf_prev) * scaling + ts_sel  # (R, num_bins)

    alive = (counts > 0)[:, None]
    out_starts = jnp.where(alive, bounds[:, :-1], 0.0)
    out_ends = jnp.where(alive, bounds[:, 1:], 0.0)
    out_masks = jnp.broadcast_to(alive, (R, n_samples))
    return out_starts, out_ends, out_masks
