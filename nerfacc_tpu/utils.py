"""High-level rendering helpers (re-creation of reference
``examples/utils.py::render_image`` for the JAX API).

``render_rays`` is the fully-jittable single-chunk path used by training
steps; ``render_image`` chunks a full image through it for evaluation
(reference ``utils.py:79-106``: 8192-ray eval chunks).

Layout note: the hot path is *dense* — samples live in an
(n_rays, slots_per_ray) grid, so field positions come from broadcasting
(never ``rays_o[ray_indices]`` gathers), transmittance is a row cumsum,
and accumulation is a row reduction. See ``ray_marching.march_rays``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ray_marching import (
    _resolve_t_range,
    march_rays,
    probe_live_groups,
    reselect_visible,
    select_slots,
)
from .vol_rendering import (
    accumulate_along_rays_dense,
    render_visibility_dense,
    render_weight_from_density_dense,
)


def make_field_fns(field, params, rays_o, rays_d, timestamps=None):
    """Build the reference's ``sigma_fn`` / ``rgb_sigma_fn`` closures
    (``examples/utils.py:50-76``) over a batch of rays — flat packed
    variant (callbacks take ``(t_starts, t_ends, ray_indices)``).

    ``field`` is a module exposing ``query_density`` and ``__call__``;
    for D-NeRF fields both take a time argument (per-ray ``timestamps``).
    """

    def positions(t_starts, t_ends, ray_indices):
        t_mid = (t_starts + t_ends) / 2.0
        return (
            rays_o[ray_indices] + t_mid * rays_d[ray_indices],
            rays_d[ray_indices],
        )

    if timestamps is None:

        def sigma_fn(t_starts, t_ends, ray_indices):
            x, _ = positions(t_starts, t_ends, ray_indices)
            return field.apply(params, x, method=field.query_density)

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            x, d = positions(t_starts, t_ends, ray_indices)
            return field.apply(params, x, d)

    else:

        def sigma_fn(t_starts, t_ends, ray_indices):
            x, _ = positions(t_starts, t_ends, ray_indices)
            t = timestamps[ray_indices]
            return field.apply(params, x, t, method=field.query_density)

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            x, d = positions(t_starts, t_ends, ray_indices)
            t = timestamps[ray_indices]
            return field.apply(params, x, t, d)

    return sigma_fn, rgb_sigma_fn


def _dense_positions(rays_o, rays_d, t_starts, t_ends):
    """Sample midpoints on the dense layout — pure broadcasting."""
    t_mid = (t_starts + t_ends) * 0.5
    return rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]


@jax.named_scope("field")
def _dense_field_query(field, params, x, rays_d=None, timestamps=None,
                       density_only=False):
    """Query a radiance field at dense (R, K, 3) positions."""
    R, K = x.shape[:2]
    xf = x.reshape(R * K, 3)
    if density_only:
        if timestamps is None:
            sigmas = field.apply(params, xf, method=field.query_density)
        else:
            t = jnp.repeat(timestamps, K, axis=0)
            sigmas = field.apply(params, xf, t, method=field.query_density)
        return sigmas.reshape(R, K)
    d = jnp.broadcast_to(rays_d[:, None, :], (R, K, 3)).reshape(R * K, 3)
    if timestamps is None:
        rgbs, sigmas = field.apply(params, xf, d)
    else:
        t = jnp.repeat(timestamps, K, axis=0)
        rgbs, sigmas = field.apply(params, xf, t, d)
    return rgbs.reshape(R, K, 3), sigmas.reshape(R, K)


@jax.named_scope("field")
def _compact_field_query(
    field, params, rays_o, rays_d, t_starts, t_ends, masks, m_budget,
    timestamps=None, density_only=False,
):
    """Query the field on the live slots only (gather-bound encoders).

    Compacts the (R, K) slot buffer's live samples into ``m_budget``
    entries (ops/sample_compact.py), evaluates the field there, and
    expands rgb/sigma back to the dense layout with a gather-transpose
    custom VJP. Returns (rgbs (R,K,3), sigmas (R,K), masks) — or
    (sigmas, masks) with ``density_only`` — where masks excludes any
    over-budget drops (size the budget above the scene's live count;
    ``masks.sum()`` reports the true rendered count either way), plus a
    trailing ``dropped`` scalar (over-budget live slots trimmed —
    proportionally across rays, see ops/sample_compact.py).
    """
    from .ops.sample_compact import compact_live_slots, expand_compact

    R, K = masks.shape
    m_budget = min(m_budget, R * K)  # a budget beyond the buffer is free
    pos, ok, rank, keep, dropped = compact_live_slots(masks, m_budget)
    t_mid = ((t_starts + t_ends) * 0.5).reshape(-1)
    tc = t_mid[pos]  # (M,)
    ridx = pos // K  # (M,) each compact sample's ray
    # one fused row gather for every per-ray quantity (see the ray-
    # compaction path above: separate gathers pay a serial index chain)
    parts = [rays_o, rays_d]
    if timestamps is not None:
        parts.append(timestamps)
    payload = jnp.concatenate(parts, axis=1)[ridx]  # (M, D)
    oc, dc = payload[:, 0:3], payload[:, 3:6]
    xc = oc + tc[:, None] * dc
    tsc = payload[:, 6:] if timestamps is not None else None
    if density_only:
        if tsc is None:
            sigmas_c = field.apply(params, xc, method=field.query_density)
        else:
            sigmas_c = field.apply(
                params, xc, tsc, method=field.query_density
            )
        dense = expand_compact(
            sigmas_c.reshape(-1, 1).astype(jnp.float32),
            rank, keep.reshape(-1), pos, ok,
        )
        return dense[:, 0].reshape(R, K), keep, dropped
    if tsc is None:
        rgbs_c, sigmas_c = field.apply(params, xc, dc)
    else:
        rgbs_c, sigmas_c = field.apply(params, xc, tsc, dc)
    vals = jnp.concatenate(
        [rgbs_c.astype(jnp.float32), sigmas_c.reshape(-1, 1)], axis=1
    )  # (M, 4)
    dense = expand_compact(vals, rank, keep.reshape(-1), pos, ok)
    rgbs = dense[:, :3].reshape(R, K, 3)
    sigmas = dense[:, 3].reshape(R, K)
    return rgbs, sigmas, keep, dropped


def render_rays(
    params,
    field,
    rays_o,
    rays_d,
    *,
    grid=None,
    scene_aabb=None,
    near_plane=None,
    far_plane=None,
    render_step_size=5e-3,
    render_bkgd=None,
    cone_angle=0.0,
    alpha_thre=0.0,
    early_stop_eps=1e-4,
    stratified=False,
    key=None,
    timestamps=None,
    max_samples_per_ray=512,
    samples_budget=None,
    visible_samples_budget=None,
    coarse_stride=1,
    probe_dilation=1,
    compact_rays_fraction=None,
    field_samples_budget=None,
    prefilter_sigma=True,
    dt_max=1e10,
    return_extras=False,
    exact_recheck=True,
    aux=None,
    return_compact=False,
    probe_groups=None,
):
    """Render one ray batch: march (no grad) + composite (with grad).

    Jittable end to end; returns (colors, opacities, depths, n_samples)
    where n_samples is the live sample count (for dynamic-batch metrics,
    reference ``train_ngp_nerf.py:236-241``).

    ``samples_budget`` sets the per-ray slot count
    ``K = ceil(budget / n_rays)`` (static shapes); ``prefilter_sigma``
    enables the reference's 2-stage cheap-cull-then-render trick
    (``utils.py:86-106``) — worth it when culling shrinks the grad-tracked
    pass more than one extra density pass costs.

    ``return_extras`` additionally returns a dict with the per-slot
    ``weights`` / ``t_starts`` / ``t_ends`` / ``deltas`` / ``masks`` (of
    the compacted ray set when compaction is on) for regularizers such as
    :func:`nerfacc_tpu.loss_distortion_dense`.

    ``compact_rays_fraction`` (needs ``grid`` and ``coarse_stride > 1``):
    rays whose probe count is zero produce pure background; drop them
    before any per-sample work and re-spread the sample budget over the
    ``H = fraction * n_rays`` rays that hit occupancy (the reference gets
    this for free from exact packing). Output rays beyond ``H`` hits in a
    batch fall back to background (no gradient) — size the fraction above
    the scene's hit rate.

    ``aux``: optional (n_rays, D) per-ray payload (e.g. target pixels)
    carried through ray compaction in the same fused row gather as the ray
    data — cheaper than a separate gather outside.

    ``return_compact`` (training fast path): with compaction on, skip the
    expand-back scatter and return the *compacted* outputs plus the
    selection, as ``(colors, opacities, depths, n_samples, sel)`` with
    ``sel = {"ray_indices", "ray_ok", "aux"}``. Losses over the full batch
    can be recovered algebraically (non-hit rays render exactly
    ``render_bkgd``): see ``bench.py``. The skipped expand is 3 row
    scatters the training loop never needs.
    """
    n_rays = rays_o.shape[0]
    if stratified and key is None:
        raise ValueError("stratified=True requires a PRNG `key`.")
    t_min, t_max = _resolve_t_range(
        rays_o, rays_d, None, None, scene_aabb, near_plane, far_plane,
        stratified, key, render_step_size,
        cone_angle=cone_angle, dt_max=dt_max,
        max_samples_per_ray=max_samples_per_ray,
    )
    S = max_samples_per_ray

    live_groups = None
    ray_sel = None  # (indices, valid) of compacted rays
    n_out = n_rays
    if (
        compact_rays_fraction is not None
        and grid is not None
        and coarse_stride > 1
    ):
        live_g = probe_live_groups(
            rays_o, rays_d, t_min, t_max, grid,
            render_step_size=render_step_size, cone_angle=cone_angle,
            max_samples_per_ray=S, coarse_stride=coarse_stride,
            dt_max=dt_max, probe_dilation=probe_dilation,
            probe_groups=probe_groups,
        )
        hit = live_g.sum(axis=1) > 0  # (R,)
        H = max(1, int(round(n_rays * compact_rays_fraction)))
        posr, okr, _ = select_slots(hit[None, :], H, decimate=False)
        ridx, ray_ok = posr[0], okr[0]
        ray_sel = (ridx, ray_ok)
        # ONE fused row gather for every per-ray quantity instead of six
        # separate gathers. Counts (<= C) and timestamps are exact in f32.
        G_ = live_g.shape[1]
        parts = [rays_o, rays_d, t_min[:, None], t_max[:, None],
                 live_g.astype(jnp.float32)]
        if timestamps is not None:
            parts.append(timestamps)
        if aux is not None:
            parts.append(aux.astype(jnp.float32))
        payload = jnp.concatenate(parts, axis=1)[ridx]  # (H, D) row gather
        rays_o, rays_d = payload[:, 0:3], payload[:, 3:6]
        t_min, t_max = payload[:, 6], payload[:, 7]
        live_groups = payload[:, 8 : 8 + G_].astype(jnp.int32)
        col = 8 + G_
        if timestamps is not None:
            timestamps = payload[:, col : col + timestamps.shape[1]]
            col += timestamps.shape[1]
        if aux is not None:
            aux = payload[:, col : col + aux.shape[1]]
        n_rays = H

    K = S if samples_budget is None else min(
        S, max(1, -(-samples_budget // n_rays))
    )
    segs = march_rays(
        rays_o, rays_d, t_min, t_max, grid,
        render_step_size=render_step_size,
        cone_angle=cone_angle,
        max_samples_per_ray=S,
        slots_per_ray=K,
        coarse_stride=coarse_stride if grid is not None else 1,
        dt_max=dt_max,
        live_groups=live_groups,
        probe_dilation=probe_dilation,
        exact_recheck=exact_recheck,
        probe_groups=probe_groups,
    )
    if ray_sel is not None:
        segs = segs._replace(masks=segs.masks & ray_sel[1][:, None])

    two_stage = prefilter_sigma and visible_samples_budget is not None
    if two_stage:
        # stage 1: cheap no-grad density pass -> visibility culling ->
        # recompact to the smaller visible budget (the reference's
        # cull-then-render trick; pays for itself because stage 2 then
        # runs on fewer slots)
        sg_params = jax.lax.stop_gradient(params)
        if field_samples_budget is not None:
            sigmas, keep1, _ = _compact_field_query(
                field, sg_params, rays_o, rays_d, segs.t_starts,
                segs.t_ends, segs.masks, field_samples_budget,
                timestamps=timestamps, density_only=True,
            )
            segs = segs._replace(masks=keep1)
        else:
            x = _dense_positions(
                rays_o, rays_d, segs.t_starts, segs.t_ends
            )
            sigmas = _dense_field_query(
                field, sg_params, x, timestamps=timestamps,
                density_only=True,
            )
        alphas = 1.0 - jnp.exp(-sigmas * segs.deltas)
        vis = render_visibility_dense(
            alphas, segs.masks,
            early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
        )
        masks = segs.masks & vis
        K2 = min(K, max(1, -(-visible_samples_budget // n_rays)))
        segs = reselect_visible(segs._replace(masks=masks), K2)

    # grad-tracked field query + composite
    t_starts = jax.lax.stop_gradient(segs.t_starts)
    t_ends = jax.lax.stop_gradient(segs.t_ends)
    deltas = jax.lax.stop_gradient(segs.deltas)
    if field_samples_budget is not None:
        # live-sample compaction: evaluate the field only on march-live
        # slots (gather-bound encoders pay per slot, live or dead; see
        # ops/sample_compact.py). Matmul-cheap fields may do better with
        # it off: the glue can cost more than the dead-lane FLOPs.
        rgbs, sigmas, masks, field_dropped = _compact_field_query(
            field, params, rays_o, rays_d, t_starts, t_ends, segs.masks,
            field_samples_budget, timestamps=timestamps,
        )
    else:
        x = _dense_positions(rays_o, rays_d, t_starts, t_ends)
        rgbs, sigmas = _dense_field_query(
            field, params, x, rays_d=rays_d, timestamps=timestamps
        )
        masks = segs.masks
        field_dropped = jnp.zeros((), jnp.int32)
    if prefilter_sigma and not two_stage:
        # without recompaction the composite runs on every slot anyway, so
        # the visibility cull is pure mask refinement off the *same*
        # (grad-tracked) density pass — one field evaluation, not two.
        alphas = 1.0 - jnp.exp(-jax.lax.stop_gradient(sigmas) * deltas)
        vis = render_visibility_dense(
            alphas, masks,
            early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
        )
        masks = masks & vis
    with jax.named_scope("composite"):
        weights = render_weight_from_density_dense(
            t_starts, t_starts + deltas, sigmas, masks=masks
        )
        colors = accumulate_along_rays_dense(
            weights, values=rgbs, masks=masks
        )
        opacities = accumulate_along_rays_dense(weights, masks=masks)
        t_mid = (t_starts + t_ends) * 0.5
        depths = accumulate_along_rays_dense(
            weights, values=t_mid[..., None], masks=masks
        )
        if render_bkgd is not None:
            colors = colors + render_bkgd * (1.0 - opacities)

    if return_compact:
        ridx, ray_ok = ray_sel if ray_sel is not None else (
            jnp.arange(n_rays, dtype=jnp.int32),
            jnp.ones((n_rays,), bool),
        )
        sel = {"ray_indices": ridx, "ray_ok": ray_ok, "aux": aux}
        if return_extras:
            sel["extras"] = {
                "weights": weights, "t_starts": t_starts, "t_ends": t_ends,
                "deltas": deltas, "masks": masks,
                "field_budget_dropped": field_dropped,
            }
        return colors, opacities, depths, masks.sum(), sel

    if ray_sel is not None:
        # expand back to the full ray batch: non-hit rays are pure
        # background with zero opacity/depth — exactly what a full render
        # would produce for rays with no live samples.
        ridx, ray_ok = ray_sel
        dest = jnp.where(ray_ok, ridx, n_out)  # invalid -> drop slot

        def expand(vals, fill):
            buf = jnp.full((n_out + 1,) + vals.shape[1:], fill, vals.dtype)
            return buf.at[dest].set(vals, mode="drop")[:n_out]

        bg = (
            jnp.broadcast_to(jnp.asarray(render_bkgd, colors.dtype), (3,))
            if render_bkgd is not None
            else jnp.zeros((3,), colors.dtype)
        )
        colors = (
            jnp.tile(bg[None], (n_out + 1, 1))
            .at[dest]
            .set(colors, mode="drop")[:n_out]
        )
        opacities = expand(opacities, 0.0)
        depths = expand(depths, 0.0)
    if return_extras:
        extras = {
            "weights": weights, "t_starts": t_starts, "t_ends": t_ends,
            "deltas": deltas, "masks": masks,
            "field_budget_dropped": field_dropped,
        }
        return colors, opacities, depths, masks.sum(), extras
    return colors, opacities, depths, masks.sum()


def render_image(
    params,
    field,
    rays_o,
    rays_d,
    *,
    test_chunk_size: int = 8192,
    eval_samples_per_ray: int = 128,
    eval_visible_samples_per_ray: Optional[int] = None,
    **kwargs,
):
    """Chunked whole-image render (reference ``utils.py:79-106``).

    ``rays_o``/``rays_d`` are flat (h*w, 3); returns stacked arrays of the
    same leading shape.

    The per-ray slot count is ``eval_samples_per_ray`` (with grid skipping
    + sigma culling, 128 live samples/ray of headroom is generous); the
    ``samples_budget`` kwarg is always re-derived from it, since a
    training-batch budget makes no sense for eval chunks.

    ``eval_visible_samples_per_ray`` controls the post-cull budget the
    same way: when set, a caller-provided ``visible_samples_budget`` is
    rescaled to ``test_chunk_size * eval_visible_samples_per_ray``. When
    left ``None`` (default) the caller's ``visible_samples_budget`` kwarg
    passes through untouched.
    """
    n = rays_o.shape[0]
    chunk = test_chunk_size
    kwargs = dict(kwargs)
    kwargs["samples_budget"] = chunk * eval_samples_per_ray
    if (
        eval_visible_samples_per_ray is not None
        and kwargs.get("visible_samples_budget") is not None
    ):
        kwargs["visible_samples_budget"] = chunk * eval_visible_samples_per_ray
    # eval renders are EXACT: live-sample compaction (a train-step
    # optimization — its budget is sized against the training batch's
    # live count) is dropped here rather than rescaled, because the
    # march-live fraction of a coherent eval view is scene-dependent
    # and any fixed budget can silently drop live samples and
    # black-hole pixels (measured on the NGP drive: train-sized budget
    # 10.23 PSNR, 2x-rescaled 18.31, exact 23.4). The two-stage
    # visibility re-selection above already bounds the eval-time field
    # cost.
    kwargs.pop("field_samples_budget", None)
    pad = (-n) % chunk
    timestamps = kwargs.pop("timestamps", None)
    if pad:
        rays_o = jnp.concatenate([rays_o, jnp.zeros((pad, 3), rays_o.dtype)])
        rays_d = jnp.concatenate(
            [rays_d, jnp.ones((pad, 3), rays_d.dtype) / np.sqrt(3.0)]
        )
        if timestamps is not None:
            timestamps = jnp.concatenate(
                [timestamps, jnp.zeros((pad, 1), timestamps.dtype)]
            )

    # one jitted chunk renderer (all chunks share a shape): eager per-chunk
    # dispatch is pathologically slow on remote-attached accelerators
    @jax.jit
    def _render_chunk(params, o, d, t):
        colors, opacities, depths, _ = render_rays(
            params, field, o, d,
            timestamps=t if timestamps is not None else None,
            **kwargs,
        )
        return colors, opacities, depths

    dummy_t = jnp.zeros((chunk, 1), jnp.float32)
    outs = []
    for i in range(0, n + pad, chunk):
        outs.append(
            _render_chunk(
                params, rays_o[i : i + chunk], rays_d[i : i + chunk],
                timestamps[i : i + chunk] if timestamps is not None else dummy_t,
            )
        )
    colors = jnp.concatenate([o[0] for o in outs])[:n]
    opacities = jnp.concatenate([o[1] for o in outs])[:n]
    depths = jnp.concatenate([o[2] for o in outs])[:n]
    return colors, opacities, depths


class DynamicRayBucketer:
    """Dynamic ray-batch sizing with static shapes.

    The reference resizes ``num_rays`` every step to keep samples/batch
    near a target (``train_ngp_nerf.py:236-241``) — under jit that is a
    recompile per step. Here ray counts snap to a geometric bucket ladder:
    each bucket compiles once, and the controller tracks an EMA of live
    samples-per-ray to pick the bucket whose expected sample count is
    closest to the target.

    Host-side and stateful (like the reference's loop-carried num_rays).
    """

    def __init__(
        self,
        target_samples: int,
        init_num_rays: int = 4096,
        min_num_rays: int = 1024,
        max_num_rays: int = 65536,
        ema: float = 0.9,
    ):
        self.target = target_samples
        self.ema = ema
        self.buckets = []
        b = min_num_rays
        while b <= max_num_rays:
            self.buckets.append(b)
            b *= 2
        self.num_rays = min(
            self.buckets, key=lambda x: abs(x - init_num_rays)
        )
        self._spr = None  # EMA of live samples per ray

    def update(self, n_live_samples: int, num_rays_used: int) -> int:
        """Feed back a step's live sample count; returns the next batch
        size (one of the buckets)."""
        spr = max(n_live_samples, 1) / max(num_rays_used, 1)
        self._spr = (
            spr if self._spr is None
            else self.ema * self._spr + (1 - self.ema) * spr
        )
        want = self.target / self._spr
        self.num_rays = min(self.buckets, key=lambda x: abs(x - want))
        return self.num_rays
