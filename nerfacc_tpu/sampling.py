"""Proposal-network sampling (dense layout).

The reference ships this only as a non-functional sketch
(``nerfacc/sampling.py`` — it calls unbound CUDA symbols, SURVEY §2.1);
here it is a working capability: MipNeRF-360-style hierarchical sampling
where cheap proposal density networks iteratively re-distribute a fixed
per-ray sample budget toward surfaces, with visibility filtering between
rounds.

Everything runs on the dense (n_rays, K) layout: transmittance is a row
cumsum, filtering is mask refinement, and CDF resampling is the dense
rank-reduce of :func:`nerfacc_tpu.cdf.ray_resampling_dense` — static
shapes, no gathers/scatters.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

from .cdf import ray_resampling_dense
from .grid import OccupancyGrid
from .ray_marching import RaySegments, march_rays
from .vol_rendering import (
    render_visibility_dense,
    render_weight_from_density_dense,
)


def sample_along_rays(
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    t_min: Union[float, jnp.ndarray],
    t_max: Union[float, jnp.ndarray],
    step_size: float,
    cone_angle: float = 0.0,
    grid: Optional[OccupancyGrid] = None,
    num_steps: Optional[int] = None,
    slots_per_ray: Optional[int] = None,
    coarse_stride: int = 1,
) -> RaySegments:
    """Sample intervals along rays (reference ``sampling.py:44-98``).

    With float ``t_min``/``t_max`` this is the reference's fixed-count
    uniform lattice (``num_steps = floor((t_max - t_min) / step_size)``);
    with per-ray tensors it marches with optional grid skipping. Static
    shapes require ``num_steps`` when t ranges are tensors.

    Returns:
        :class:`RaySegments` (dense (n_rays, K) layout; ``.ray_indices``
        and flattening give the reference's packed triple).
    """
    n_rays = rays_o.shape[0]
    if isinstance(t_min, float) and isinstance(t_max, float) and grid is None:
        if num_steps is None:
            num_steps = int(math.floor((t_max - t_min) / step_size))
        t_min = jnp.full((n_rays,), t_min, jnp.float32)
        t_max_arr = jnp.full((n_rays,), t_max, jnp.float32)
    else:
        assert num_steps is not None, (
            "num_steps must be given (static shapes) for tensor t ranges"
        )
        t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n_rays,))
        t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n_rays,))
    return march_rays(
        rays_o, rays_d, t_min, t_max_arr, grid,
        render_step_size=step_size,
        cone_angle=cone_angle,
        max_samples_per_ray=num_steps,
        slots_per_ray=slots_per_ray or num_steps,
        coarse_stride=coarse_stride if grid is not None else 1,
    )


def proposal_sampling_with_filter(
    segments: RaySegments,
    sigma_fn: Optional[Callable] = None,
    proposal_sigma_fns: Sequence[Callable] = (),
    proposal_n_samples: Sequence[int] = (),
    proposal_require_grads: bool = False,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
) -> Tuple[RaySegments, list]:
    """Hierarchical proposal sampling (working re-design of reference
    ``sampling.py:101-187``).

    Each round: evaluate a proposal density on the current samples,
    visibility-filter (``early_stop_eps`` / ``alpha_thre``, mask
    refinement), then redistribute ``n`` samples per ray by inverse-CDF of
    the rendering weights. A final ``sigma_fn`` round filters only.

    Density callbacks take dense ``(t_starts, t_ends)`` of shape
    (n_rays, K) and return densities of the same shape.

    Returns:
        (final RaySegments, proposal_samples) where ``proposal_samples``
        is a list of (t_starts, t_ends, weights, masks) per round with
        gradients attached (for proposal-network losses) when
        ``proposal_require_grads``.
    """
    assert len(proposal_sigma_fns) == len(proposal_n_samples), (
        "proposal_sigma_fns and proposal_n_samples must have the same "
        f"length, got {len(proposal_sigma_fns)} / {len(proposal_n_samples)}."
    )
    t_starts, t_ends, masks = (
        segments.t_starts, segments.t_ends, segments.masks,
    )
    proposal_samples = []
    for proposal_fn, n_samples in zip(proposal_sigma_fns, proposal_n_samples):
        sigmas = proposal_fn(
            jax.lax.stop_gradient(t_starts), jax.lax.stop_gradient(t_ends)
        )
        assert sigmas.shape == t_starts.shape
        weights = render_weight_from_density_dense(
            t_starts, t_ends, sigmas, masks=masks
        )
        if alpha_thre > 0 or early_stop_eps > 0:
            alphas = 1.0 - jnp.exp(
                -jax.lax.stop_gradient(sigmas) * (t_ends - t_starts)
            )
            vis = render_visibility_dense(
                alphas, masks,
                early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
            )
            masks = masks & vis
        if proposal_require_grads:
            proposal_samples.append((t_starts, t_ends, weights, masks))
        t_starts, t_ends, masks = ray_resampling_dense(
            t_starts, t_ends,
            jax.lax.stop_gradient(weights), n_samples, masks=masks,
        )

    if (alpha_thre > 0 or early_stop_eps > 0) and sigma_fn is not None:
        sigmas = sigma_fn(t_starts, t_ends)
        assert sigmas.shape == t_starts.shape
        alphas = 1.0 - jnp.exp(-sigmas * (t_ends - t_starts))
        vis = render_visibility_dense(
            alphas, masks, early_stop_eps=early_stop_eps,
            alpha_thre=alpha_thre,
        )
        masks = masks & vis

    out = RaySegments(
        t_starts=t_starts, t_ends=t_ends,
        deltas=t_ends - t_starts, masks=masks,
    )
    return out, proposal_samples
