"""Reference-faithful numpy oracle: the CUDA kernels' serial algorithms.

BASELINE.json's north star is "forward/backward verified allclose against
reference rendered images + pixel gradients". The reference's CUDA cannot
run here, but its serial per-ray algorithms are ~200 lines of portable
math. This module transliterates their *behavior* (not their code) into
numpy so the JAX pipeline can be checked against an independent oracle:

  * ``ray_marching``        — the per-ray DDA while-loop with occupancy
                              skip (reference ``cuda/csrc/ray_marching.cu:81-192``,
                              helpers ``:9-75``)
  * ``weights_from_sigma``  — serial transmittance accumulation
                              (``cuda/csrc/render_weight.cu:7-38``)
  * ``grad_sigmas``         — the closed-form suffix-accumulator backward
                              (``cuda/csrc/render_weight.cu:41-84``)
  * ``transmittance_from_sigma`` fwd/bwd
                              (``cuda/csrc/render_transmittance.cu:7-82``)
  * ``accumulate_along_rays`` / ``rendering_forward`` / ``rendering_backward``
                              — the python-level compositor and its exact
                              linear backward (reference
                              ``nerfacc/vol_rendering.py:15-198``)

Everything is float64-capable (pass ``dtype``) so the oracle can also act
as a high-precision ground truth; with float32 it reproduces the
reference's arithmetic order (serial front-to-back accumulation).

Only ContractionType.AABB is implemented for marching — the oracle's job
is the bounded-scene parity gate (the reference's DDA skip is AABB-only;
other contractions take the step-every-sample branch, covered by the
``grid=None``/dense-march cases).
"""

from __future__ import annotations

import numpy as np


def calc_dt(t, cone_angle, dt_min, dt_max):
    """reference ``ray_marching.cu:9-14``."""
    return np.clip(t * cone_angle, dt_min, dt_max)


def grid_idx_at(xyz_unit, res):
    """reference ``ray_marching.cu:16-25`` (row-major x,y,z)."""
    ixyz = np.clip((xyz_unit * res).astype(np.int64), 0, np.asarray(res) - 1)
    return (ixyz[0] * res[1] + ixyz[1]) * res[2] + ixyz[2]


def grid_occupied_at(xyz, roi_min, roi_max, binary):
    """reference ``ray_marching.cu:27-45`` (AABB contraction only)."""
    if np.any(xyz < roi_min) or np.any(xyz > roi_max):
        return False
    unit = (xyz - roi_min) / (roi_max - roi_min)
    res = binary.shape
    return bool(binary.reshape(-1)[grid_idx_at(unit, res)])


def distance_to_next_voxel(xyz, d, inv_d, roi_min, roi_max, res):
    """reference ``ray_marching.cu:48-57``."""
    res_f = np.asarray(res, dtype=xyz.dtype)
    _xyz = (xyz - roi_min) / (roi_max - roi_min) * res_f
    txyz = (
        (np.floor(_xyz + 0.5 + 0.5 * np.sign(d)) - _xyz) * inv_d
    ) / res_f * (roi_max - roi_min)
    return max(float(txyz.min()), 0.0)


def advance_to_next_voxel(t, dt_min, xyz, d, inv_d, roi_min, roi_max, res, far):
    """reference ``ray_marching.cu:59-75``: step in dt_min multiples until
    past the next voxel boundary (lattice-preserving)."""
    t_target = min(
        t + distance_to_next_voxel(xyz, d, inv_d, roi_min, roi_max, res), far
    )
    _t = t
    while True:
        _t += dt_min
        if _t >= t_target:
            return _t


def ray_marching(
    rays_o,
    rays_d,
    t_min,
    t_max,
    roi_aabb,
    binary,
    step_size,
    cone_angle=0.0,
    dtype=np.float64,
):
    """Serial per-ray march (reference ``ray_marching.cu:81-192``).

    Returns (ray_indices, t_starts, t_ends) packed arrays, exactly the
    reference's two-pass output (one pass suffices in numpy — python
    lists replace the count/allocate dance).
    """
    rays_o = np.asarray(rays_o, dtype)
    rays_d = np.asarray(rays_d, dtype)
    roi = np.asarray(roi_aabb, dtype)
    roi_min, roi_max = roi[:3], roi[3:]
    res = binary.shape
    dt_min, dt_max = dtype(step_size), dtype(1e10)

    ray_indices, t_starts, t_ends = [], [], []
    for i in range(rays_o.shape[0]):
        o, d = rays_o[i], rays_d[i]
        with np.errstate(divide="ignore"):
            inv_d = dtype(1.0) / d
        near, far = dtype(t_min[i]), dtype(t_max[i])

        t0 = near
        dt = calc_dt(t0, cone_angle, dt_min, dt_max)
        t1 = t0 + dt
        t_mid = (t0 + t1) * dtype(0.5)
        while t_mid < far:
            xyz = o + t_mid * d
            if grid_occupied_at(xyz, roi_min, roi_max, binary):
                ray_indices.append(i)
                t_starts.append(t0)
                t_ends.append(t1)
                t0 = t1
                t1 = t0 + calc_dt(t0, cone_angle, dt_min, dt_max)
                t_mid = (t0 + t1) * dtype(0.5)
            else:
                # AABB: DDA skip to the next voxel boundary
                t_mid = advance_to_next_voxel(
                    t_mid, dt_min, xyz, d, inv_d, roi_min, roi_max, res, far
                )
                dt = calc_dt(t_mid, cone_angle, dt_min, dt_max)
                t0 = t_mid - dt * dtype(0.5)
                t1 = t_mid + dt * dtype(0.5)

    return (
        np.asarray(ray_indices, np.int64),
        np.asarray(t_starts, dtype),
        np.asarray(t_ends, dtype),
    )


def _iter_rays(packed_info):
    for base, steps in packed_info:
        yield int(base), int(steps)


def pack_info(ray_indices, n_rays):
    """reference ``nerfacc/pack.py:46-77``: counts + exclusive cumsum."""
    counts = np.bincount(ray_indices, minlength=n_rays)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.stack([starts, counts], axis=1).astype(np.int64)


def weights_from_sigma(packed_info, t_starts, t_ends, sigmas, dtype=None):
    """Serial forward (reference ``render_weight.cu:7-38``)."""
    dtype = np.dtype(dtype or t_starts.dtype).type
    weights = np.zeros_like(sigmas, dtype=dtype)
    for base, steps in _iter_rays(packed_info):
        T = dtype(1.0)
        for j in range(base, base + steps):
            delta = t_ends[j] - t_starts[j]
            alpha = dtype(1.0) - np.exp(-sigmas[j] * delta)
            weights[j] = alpha * T
            T *= dtype(1.0) - alpha
    return weights


def grad_sigmas_from_weights(
    packed_info, t_starts, t_ends, sigmas, weights, grad_weights, dtype=None
):
    """Serial backward (reference ``render_weight.cu:41-84``): the
    suffix-accumulator identity dL/dsigma_j = (g_j T_j - sum_{k>=j} g_k w_k
    + g_j w_j) * delta_j computed with a running accumulator."""
    dtype = np.dtype(dtype or t_starts.dtype).type
    grad_sigmas = np.zeros_like(sigmas, dtype=dtype)
    for base, steps in _iter_rays(packed_info):
        accum = dtype(0.0)
        for j in range(base, base + steps):
            accum += grad_weights[j] * weights[j]
        T = dtype(1.0)
        for j in range(base, base + steps):
            delta = t_ends[j] - t_starts[j]
            alpha = dtype(1.0) - np.exp(-sigmas[j] * delta)
            grad_sigmas[j] = (grad_weights[j] * T - accum) * delta
            accum -= grad_weights[j] * weights[j]
            T *= dtype(1.0) - alpha
    return grad_sigmas


def transmittance_from_sigma(packed_info, t_starts, t_ends, sigmas, dtype=None):
    """Serial forward (reference ``render_transmittance.cu:7-44``):
    T_j = exp(-sum_{k<j} sigma_k delta_k)."""
    dtype = np.dtype(dtype or t_starts.dtype).type
    trans = np.zeros_like(sigmas, dtype=dtype)
    for base, steps in _iter_rays(packed_info):
        cumsum = dtype(0.0)
        for j in range(base, base + steps):
            trans[j] = np.exp(-cumsum)
            cumsum += sigmas[j] * (t_ends[j] - t_starts[j])
    return trans


def grad_sigmas_from_transmittance(
    packed_info, t_starts, t_ends, trans, grad_trans, dtype=None
):
    """Serial backward (reference ``render_transmittance.cu:47-82``):
    dL/dsigma_j = -delta_j * sum_{k>j} g_k T_k (reverse suffix sum)."""
    dtype = np.dtype(dtype or t_starts.dtype).type
    grad_sigmas = np.zeros_like(trans, dtype=dtype)
    for base, steps in _iter_rays(packed_info):
        accum = dtype(0.0)
        for j in range(base + steps - 1, base - 1, -1):
            grad_sigmas[j] = -(t_ends[j] - t_starts[j]) * accum
            accum += grad_trans[j] * trans[j]
    return grad_sigmas


def accumulate_along_rays(weights, ray_indices, values, n_rays):
    """reference ``nerfacc/vol_rendering.py:132-198`` (scatter-add)."""
    if values is None:
        src = weights[:, None]
    else:
        src = weights[:, None] * values
    out = np.zeros((n_rays, src.shape[1]), src.dtype)
    np.add.at(out, ray_indices, src)
    return out


def rendering_forward(
    packed_info, ray_indices, t_starts, t_ends, sigmas, rgbs, n_rays,
    render_bkgd=None,
):
    """reference ``nerfacc/vol_rendering.py:15-129``: weights -> color /
    opacity / depth -> background composite."""
    weights = weights_from_sigma(packed_info, t_starts, t_ends, sigmas)
    colors = accumulate_along_rays(weights, ray_indices, rgbs, n_rays)
    opacities = accumulate_along_rays(weights, ray_indices, None, n_rays)
    depths = accumulate_along_rays(
        weights, ray_indices, ((t_starts + t_ends) * 0.5)[:, None], n_rays
    )
    if render_bkgd is not None:
        colors = colors + (1.0 - opacities) * render_bkgd[None, :]
    return colors, opacities, depths, weights


def rendering_backward(
    packed_info, ray_indices, t_starts, t_ends, sigmas, rgbs, weights,
    grad_colors, n_rays, render_bkgd=None,
):
    """Exact backward of :func:`rendering_forward` w.r.t. (sigmas, rgbs)
    for a loss with cotangent ``grad_colors`` on the composited colors.

    The compositor is linear in weights and rgbs:
      d rgbs_j    = w_j * grad_colors[ray_j]
      d weights_j = rgbs_j . grad_colors[ray_j] - bkgd . grad_colors[ray_j]
    then d sigmas via the reference's closed-form weight backward.
    """
    g_ray = grad_colors[ray_indices]  # (n_samples, 3)
    grad_rgbs = weights[:, None] * g_ray
    grad_weights = np.sum(rgbs * g_ray, axis=1)
    if render_bkgd is not None:
        grad_weights = grad_weights - np.sum(
            render_bkgd[None, :] * g_ray, axis=1
        )
    grad_sigmas = grad_sigmas_from_weights(
        packed_info, t_starts, t_ends, sigmas, weights, grad_weights
    )
    return grad_sigmas, grad_rgbs
