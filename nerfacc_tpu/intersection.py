"""Ray/AABB intersection (pure jnp).

Vectorized slab test; replaces the reference's one-thread-per-ray CUDA
kernel (``nerfacc/cuda/csrc/intersection.cu:15-91``). XLA fuses it into
a handful of elementwise ops over the ray batch.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

MAX_DIST = 1e10


def ray_aabb_intersect(
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    aabb: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Intersect rays with one axis-aligned bounding box.

    Semantics match the reference (``intersection.py:13-50``): ``t_min`` is
    clamped to be >= 0, and rays that miss the box get
    ``t_min = t_max = 1e10``.

    Args:
        rays_o: (n_rays, 3) ray origins.
        rays_d: (n_rays, 3) normalized ray directions.
        aabb: (6,) box ``{minx, miny, minz, maxx, maxy, maxz}``.

    Returns:
        (t_min, t_max), each (n_rays,).
    """
    aabb = jnp.asarray(aabb, dtype=rays_o.dtype)
    inv_d = 1.0 / rays_d
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t_near = jnp.maximum(t_near, 0.0)
    hit = t_far >= t_near
    t_min = jnp.where(hit, t_near, MAX_DIST)
    t_max = jnp.where(hit, t_far, MAX_DIST)
    return t_min, t_max
