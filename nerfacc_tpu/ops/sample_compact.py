"""Live-sample compaction for expensive field encoders.

The dense ``(n_rays, K)`` slot layout trades exact packing for static
shapes: at the bench config only ~40% of slots carry a live sample
(march mask), yet the radiance field is evaluated on every slot. For
matmul-cheap fields (TensoCP) the dead-lane FLOPs can cost less than the
compaction glue; for gather-bound fields (the hash-grid NGP encoder, 128
gathered elements per point) dead slots cost real gathers, so the field
evaluation is compacted to live samples (``field_samples_budget``).

Design: both directions are GATHERS (no scatter-add in the hot autodiff
path):

  * selection: ``rank = cumsum(mask) - 1`` (cheap row scan) gives each
    live slot its compact position; the inverse map ``pos`` (compact ->
    flat slot) is ONE static-shape scatter-set of the iota (sorted
    unique destinations) outside the differentiated graph;
  * compact-side inputs (positions, directions, timestamps) are
    gathered with ``pos`` — sampling is stop-gradient throughout this
    framework, so no backward exists here;
  * :func:`expand_compact` puts field outputs back on the dense layout
    via a ``rank`` gather, with a custom VJP whose backward is the
    ``pos`` gather (the transpose of an injective selection gather is
    itself a gather — XLA's autodiff would emit a sort-based
    scatter-add because it cannot prove injectivity).

Reference behavior replaced: the CUDA toolbox gets exact packing for
free from its count-then-allocate marcher
(reference ``cuda/csrc/ray_marching.cu:194-289``) so every field
evaluation there is live by construction; this module recovers that
property for the static slot layout at the cost of one scatter-set and
a few 1-D gathers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def compact_live_slots(masks: jnp.ndarray, m_budget: int):
    """Plan a compaction of the live slots of ``masks`` into ``m_budget``
    compact positions (flat row-major order, i.e. front-to-back within
    each ray, rays in batch order).

    Over-budget behavior (budget below the scene's live count — a sizing
    error, but one that must degrade gracefully): each ray keeps a
    front-to-back PREFIX under a proportional per-ray quota
    ``max(1, floor(c_r * M / count))`` rather than the batch keeping a
    flat prefix — a flat prefix would silently zero every sample of the
    LAST rays of the batch (round-4 advisor finding). Every ray with any
    live sample keeps at least one; the far tail is what gets trimmed
    (far samples are the most likely occluded anyway). A global
    ``rank < M`` backstop guarantees the compact buffer never overflows
    even with the +1-per-ray floor. Callers must AND ``keep`` back into
    their masks and should surface ``dropped`` as a diagnostic.

    Args:
        masks: (R, K) bool dense slot liveness.
        m_budget: static compact capacity M.

    Returns:
        pos: (M,) int32 flat slot index of each compact entry (0 for
            unused entries — gate with ``ok``).
        ok: (M,) bool compact entry holds a real sample.
        rank: (R * K,) int32 compact position of each flat slot
            (valid where ``keep``).
        keep: (R, K) bool = masks minus any over-budget drops.
        dropped: () int32 number of live slots dropped (0 when the
            budget covers the live count).
    """
    n = masks.size
    mi = masks.astype(jnp.int32)
    row_inc = jnp.cumsum(mi, axis=1)  # within-ray 1-based live rank
    c_r = row_inc[:, -1]  # per-ray live counts
    count = c_r.sum()
    # proportional quota in f32 (c_r * M overflows int32 at bench
    # scale; the f32 product's <=1-ulp round-up is absorbed by the
    # global rank backstop below)
    ratio = m_budget / jnp.maximum(count, 1).astype(jnp.float32)
    quota = jnp.where(
        count > m_budget,
        jnp.maximum(
            jnp.floor(c_r.astype(jnp.float32) * ratio).astype(jnp.int32),
            jnp.minimum(c_r, 1),
        ),
        c_r,
    )
    keep2 = masks & (row_inc <= quota[:, None])
    flat = keep2.reshape(-1)
    inc = jnp.cumsum(flat.astype(jnp.int32))
    rank = inc - 1
    keep = flat & (rank < m_budget)
    kept = jnp.minimum(inc[-1], m_budget)
    # destinations are unique and sorted; out-of-range (dropped/dead)
    # entries fall off via mode="drop"
    dest = jnp.where(keep, rank, m_budget)
    pos = (
        jnp.zeros((m_budget,), jnp.int32)
        .at[dest]
        .set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    ok = jnp.arange(m_budget, dtype=jnp.int32) < kept
    return pos, ok, rank, keep.reshape(masks.shape), count - kept


def _expand_impl(vals, rank, keep_flat):
    m = vals.shape[0]
    safe = jnp.clip(rank, 0, m - 1)
    # per-column 1-D gathers: a (HK, D) row gather of narrow rows would
    # tile-pad D -> 128 lanes (the round-2/3 layout lesson)
    cols = [
        jnp.where(keep_flat, vals[:, d][safe], 0.0)
        for d in range(vals.shape[1])
    ]
    return jnp.stack(cols, axis=1)


@jax.custom_vjp
def expand_compact(vals, rank, keep_flat, pos, ok):
    """Scatter compact field outputs back onto the dense flat layout —
    phrased as a gather both ways.

    Args:
        vals: (M, D) f32 compact per-sample outputs (differentiable).
        rank: (HK,) int32 from :func:`compact_live_slots`.
        keep_flat: (HK,) bool flat ``keep``.
        pos: (M,) int32 from :func:`compact_live_slots` (backward side).
        ok: (M,) bool from :func:`compact_live_slots` (backward side).

    Returns:
        (HK, D) f32; dead/dropped slots are exactly 0.
    """
    return _expand_impl(vals, rank, keep_flat)


def _expand_fwd(vals, rank, keep_flat, pos, ok):
    return _expand_impl(vals, rank, keep_flat), (pos, ok, vals.shape)


def _expand_bwd(res, g):
    pos, ok, (m, d) = res
    g = g.astype(jnp.float32)
    okf = ok.astype(jnp.float32)
    cols = [g[:, c][pos] * okf for c in range(d)]
    d_vals = jnp.stack(cols, axis=1)
    # int/bool primals take None cotangents (JAX drops them)
    return (d_vals, None, None, None, None)


expand_compact.defvjp(_expand_fwd, _expand_bwd)
