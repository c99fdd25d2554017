"""Differentiable volumetric rendering over packed samples.

Re-implements the reference's rendering math (``nerfacc/vol_rendering.py``,
``cuda/csrc/render_transmittance*.cu``, ``render_weight.cu``) as segmented
scans (see :mod:`nerfacc_tpu.scan`). The reference's naive/CUB duality
collapses: the CUB segmented-scan formulation is the only one — it is the
XLA-native one.

Backward passes use the closed-form identities of the reference kernels
(reverse segmented suffix sums, ``render_transmittance_cub.cu:74-166``,
``render_weight.cu:67-151``) via ``jax.custom_vjp``, with fp32 accumulation
regardless of input dtype.

Static-shape contract: packed inputs have fixed capacity; invalid entries
are flagged by ``masks`` and are neutralized internally (density/alpha
treated as 0), so they cannot affect any ray's output.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pack import pack_info, unpack_info
from .scan import (
    exclusive_segment_cumprod,
    exclusive_segment_cumsum,
    reverse_exclusive_segment_cumsum,
    segment_sum,
)

__all__ = [
    "rendering",
    "rendering_dense",
    "accumulate_along_rays",
    "accumulate_along_rays_dense",
    "render_transmittance_from_density",
    "render_transmittance_from_alpha",
    "render_weight_from_density",
    "render_weight_from_alpha",
    "render_weight_from_density_dense",
    "render_weight_from_alpha_dense",
    "render_visibility",
    "render_visibility_dense",
]


def _int_zero_cotangent(x):
    return np.zeros(x.shape, dtype=jax.dtypes.float0)


def _flatten(x):
    """(N, 1) -> (N,); passthrough for (N,). Returns (array, had_last_dim)."""
    if x.ndim == 2 and x.shape[-1] == 1:
        return x[:, 0], True
    return x, False


def _reshape_like(x, had_last_dim):
    return x[:, None] if had_last_dim else x


# The flat (parity-API) segmented-scan path pays per-sample gathers where
# the dense row-op twins pay row cumsums (its cost on the GPU is not
# measured).
# When the packed layout provably IS a flat view of a dense ray-major
# (n_rays, K) buffer — iota-like ray_indices, or packed_info rows
# [r*K, K] — the flat entry points silently reroute to the dense twin
# (identical math, fp-rounding-level differences from cumsum order).
# Detection is value-based and therefore only possible on CONCRETE
# arrays (eager calls, e.g. a user port of reference code); traced
# arrays under jit skip the check. Set to False to force the segmented
# path (equivalence tests / microbenchs).
DENSE_BRIDGE = True


def _detect_dense_layout(ray_indices, packed_info, n_samples, n_rays):
    """Return (K, n_rays) when the flat packed layout is provably a dense
    ray-major fixed-K buffer, else None. Concrete inputs only."""
    if not DENSE_BRIDGE:
        return None
    if packed_info is not None:
        if isinstance(packed_info, jax.core.Tracer):
            return None
        pi = np.asarray(packed_info)
        if pi.ndim != 2 or pi.shape[1] != 2:
            return None
        R = pi.shape[0]
        if R == 0 or n_samples % R:
            return None
        K = n_samples // R
        if (pi[:, 0] == np.arange(R, dtype=pi.dtype) * K).all() and (
            pi[:, 1] == K
        ).all():
            return K, R
        return None
    if ray_indices is None or isinstance(ray_indices, jax.core.Tracer):
        return None
    if not n_rays or n_samples % n_rays:
        return None
    K = n_samples // n_rays
    idx = np.asarray(ray_indices)
    if (
        idx.reshape(n_rays, K)
        == np.arange(n_rays, dtype=idx.dtype)[:, None]
    ).all():
        return K, n_rays
    return None


def _resolve_indices(
    ray_indices, packed_info, n_samples: int, n_rays: Optional[int]
):
    """Return (ray_indices, n_rays) with n_rays static."""
    if ray_indices is None:
        if packed_info is None:
            raise ValueError(
                "Either ray_indices or packed_info should be provided."
            )
        ray_indices = unpack_info(packed_info, n_samples)
        n_rays = packed_info.shape[0]
    if n_rays is None:
        # Static upper bound: every sample on its own ray. Correct, only
        # slightly wasteful; pass n_rays for speed.
        n_rays = n_samples
    return ray_indices.astype(jnp.int32), n_rays


# ---------------------------------------------------------------------------
# Transmittance from density: T_i = exp(-sum_{j<i} sigma_j * delta_j)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _trans_from_density(sigmas, deltas, ray_indices, n_rays):
    sd = sigmas * deltas
    acc = exclusive_segment_cumsum(sd, ray_indices, n_rays)
    return jnp.exp(-acc)


def _trans_from_density_fwd(sigmas, deltas, ray_indices, n_rays):
    trans = _trans_from_density(sigmas, deltas, ray_indices, n_rays)
    return trans, (deltas, ray_indices, trans)


def _trans_from_density_bwd(n_rays, res, g):
    # dL/dsigma_i = -delta_i * sum_{j>i} g_j * T_j
    # (reference render_transmittance.cu:76-82 / _cub.cu:74-109).
    deltas, ray_indices, trans = res
    suffix = reverse_exclusive_segment_cumsum(g * trans, ray_indices, n_rays)
    grad_sigmas = -deltas * suffix
    return grad_sigmas, jnp.zeros_like(deltas), _int_zero_cotangent(ray_indices)


_trans_from_density.defvjp(_trans_from_density_fwd, _trans_from_density_bwd)


# ---------------------------------------------------------------------------
# Transmittance from alpha: T_i = prod_{j<i} (1 - alpha_j)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _trans_from_alpha(alphas, ray_indices, n_rays):
    # CUB ExclusiveProductByKey equivalent.
    return exclusive_segment_cumprod(1.0 - alphas, ray_indices, n_rays)


def _trans_from_alpha_fwd(alphas, ray_indices, n_rays):
    trans = _trans_from_alpha(alphas, ray_indices, n_rays)
    return trans, (alphas, ray_indices, trans)


def _trans_from_alpha_bwd(n_rays, res, g):
    # dL/dalpha_i = -(sum_{j>i} g_j * T_j) / (1 - alpha_i)
    # (reference render_transmittance.cu:137-143).
    alphas, ray_indices, trans = res
    suffix = reverse_exclusive_segment_cumsum(g * trans, ray_indices, n_rays)
    grad_alphas = -suffix / jnp.maximum(1.0 - alphas, 1e-10)
    return grad_alphas, _int_zero_cotangent(ray_indices)


_trans_from_alpha.defvjp(_trans_from_alpha_fwd, _trans_from_alpha_bwd)


# ---------------------------------------------------------------------------
# Weights: w_i = T_i * alpha_i  (fused, with closed-form backward)
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _weight_from_density(sigmas, deltas, ray_indices, n_rays):
    sd = sigmas * deltas
    acc = exclusive_segment_cumsum(sd, ray_indices, n_rays)
    trans = jnp.exp(-acc)
    alphas = 1.0 - jnp.exp(-sd)
    return trans * alphas


def _weight_from_density_fwd(sigmas, deltas, ray_indices, n_rays):
    sd = sigmas * deltas
    acc = exclusive_segment_cumsum(sd, ray_indices, n_rays)
    trans = jnp.exp(-acc)
    weights = trans * (1.0 - jnp.exp(-sd))
    return weights, (deltas, ray_indices, trans, weights)


def _weight_from_density_bwd(n_rays, res, g):
    # dL/dsigma_i = delta_i * (g_i T_i - sum_{j>=i} g_j w_j)
    # (classic identity, reference render_weight.cu:67-82).
    deltas, ray_indices, trans, weights = res
    gw = g * weights
    suffix_incl = reverse_exclusive_segment_cumsum(gw, ray_indices, n_rays) + gw
    grad_sigmas = deltas * (g * trans - suffix_incl)
    return grad_sigmas, jnp.zeros_like(deltas), _int_zero_cotangent(ray_indices)


_weight_from_density.defvjp(_weight_from_density_fwd, _weight_from_density_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _weight_from_alpha(alphas, ray_indices, n_rays):
    trans = _trans_from_alpha(alphas, ray_indices, n_rays)
    return trans * alphas


def _weight_from_alpha_fwd(alphas, ray_indices, n_rays):
    trans = _trans_from_alpha(alphas, ray_indices, n_rays)
    weights = trans * alphas
    return weights, (alphas, ray_indices, trans, weights)


def _weight_from_alpha_bwd(n_rays, res, g):
    # dL/dalpha_i = g_i T_i - (sum_{j>i} g_j w_j) / (1 - alpha_i)
    # (reference render_weight.cu:137-151).
    alphas, ray_indices, trans, weights = res
    suffix = reverse_exclusive_segment_cumsum(g * weights, ray_indices, n_rays)
    grad_alphas = g * trans - suffix / jnp.maximum(1.0 - alphas, 1e-10)
    return grad_alphas, _int_zero_cotangent(ray_indices)


_weight_from_alpha.defvjp(_weight_from_alpha_fwd, _weight_from_alpha_bwd)


# ---------------------------------------------------------------------------
# Dense (n_rays, K) fast path: one ray per row, so the reference's segmented
# scans collapse to plain row cumsums — no segment ids, no gathers. This is
# the layout the marcher emits (ray_marching.march_rays) and the one the
# training hot loop uses.
# ---------------------------------------------------------------------------


@jax.custom_vjp
def _weight_from_density_dense(sigmas, deltas):
    sd = sigmas * deltas
    acc = jnp.cumsum(sd, axis=1) - sd  # exclusive row cumsum
    return jnp.exp(-acc) * (1.0 - jnp.exp(-sd))


def _weight_from_density_dense_fwd(sigmas, deltas):
    sd = sigmas * deltas
    acc = jnp.cumsum(sd, axis=1) - sd
    trans = jnp.exp(-acc)
    weights = trans * (1.0 - jnp.exp(-sd))
    return weights, (deltas, trans, weights)


def _weight_from_density_dense_bwd(res, g):
    # dL/dsigma_i = delta_i * (g_i T_i - sum_{j>=i} g_j w_j)
    # (reference render_weight.cu:67-82), suffix sum = reversed row cumsum.
    deltas, trans, weights = res
    gw = g * weights
    suffix_incl = jnp.cumsum(gw[:, ::-1], axis=1)[:, ::-1]
    grad_sigmas = deltas * (g * trans - suffix_incl)
    return grad_sigmas, jnp.zeros_like(deltas)


_weight_from_density_dense.defvjp(
    _weight_from_density_dense_fwd, _weight_from_density_dense_bwd
)


def _exclusive_cumprod_rows(x):
    """True exclusive row cumprod: out[:, i] = prod_{j<i} x[:, j].

    Implemented by shift-then-cumprod rather than the
    ``cumprod(x)/x`` trick, which returns 0 (not the exclusive
    product) whenever some ``x`` saturates to exactly 0 — routine for
    converged opaque surfaces where ``alpha == 1.0`` in f32."""
    shifted = jnp.concatenate([jnp.ones_like(x[:, :1]), x[:, :-1]], axis=1)
    return jnp.cumprod(shifted, axis=1)


@jax.custom_vjp
def _weight_from_alpha_dense(alphas):
    trans = _exclusive_cumprod_rows(1.0 - alphas)
    return trans * alphas


def _weight_from_alpha_dense_fwd(alphas):
    trans = _exclusive_cumprod_rows(1.0 - alphas)
    weights = trans * alphas
    return weights, (alphas, trans, weights)


def _weight_from_alpha_dense_bwd(res, g):
    # dL/dalpha_i = g_i T_i - (sum_{j>i} g_j w_j) / (1 - alpha_i)
    # (reference render_weight.cu:137-151).
    alphas, trans, weights = res
    gw = g * weights
    suffix_excl = jnp.cumsum(gw[:, ::-1], axis=1)[:, ::-1] - gw
    grad_alphas = g * trans - suffix_excl / jnp.maximum(1.0 - alphas, 1e-10)
    return (grad_alphas,)


_weight_from_alpha_dense.defvjp(
    _weight_from_alpha_dense_fwd, _weight_from_alpha_dense_bwd
)


def render_weight_from_density_dense(t_starts, t_ends, sigmas, masks=None):
    """Rendering weights ``w_i = T_i (1 - exp(-sigma_i delta_i))`` on the
    dense (n_rays, K) layout — the row-cumsum equivalent of
    :func:`render_weight_from_density`. Invalid slots get weight 0 and do
    not influence any other slot."""
    deltas = t_ends - t_starts
    if masks is not None:
        sigmas = jnp.where(masks, sigmas, 0.0)
        deltas = jnp.where(masks, deltas, 0.0)
    return _weight_from_density_dense(sigmas, deltas)


def render_weight_from_alpha_dense(alphas, masks=None):
    """Rendering weights ``w_i = T_i alpha_i`` on the dense layout."""
    if masks is not None:
        alphas = jnp.where(masks, alphas, 0.0)
    return _weight_from_alpha_dense(alphas)


def render_transmittance_from_density_dense(t_starts, t_ends, sigmas, masks=None):
    """Transmittance on the dense layout (exclusive row cumsum)."""
    deltas = t_ends - t_starts
    if masks is not None:
        sigmas = jnp.where(masks, sigmas, 0.0)
        deltas = jnp.where(masks, deltas, 0.0)
    sd = sigmas * deltas
    return jnp.exp(-(jnp.cumsum(sd, axis=1) - sd))


def render_transmittance_from_alpha_dense(alphas, masks=None):
    """Transmittance ``T_i = prod_{j<i} (1 - alpha_j)`` on the dense layout."""
    if masks is not None:
        alphas = jnp.where(masks, alphas, 0.0)
    return _exclusive_cumprod_rows(1.0 - alphas)


def render_visibility_dense(
    alphas, masks=None, early_stop_eps: float = 1e-4, alpha_thre: float = 0.0
):
    """Visibility mask on the dense layout: ``T >= early_stop_eps`` and
    ``alpha >= alpha_thre`` (reference ``vol_rendering.py:452-520``)."""
    alphas = jax.lax.stop_gradient(alphas)
    if masks is not None:
        alphas = jnp.where(masks, alphas, 0.0)
    trans = render_transmittance_from_alpha_dense(alphas)
    vis = trans >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (alphas >= alpha_thre)
    if masks is not None:
        vis = vis & masks
    return vis


def accumulate_along_rays_dense(weights, values=None, masks=None):
    """Per-ray accumulation on the dense layout: ``sum_k w_k v_k`` along
    the slot axis. Returns (n_rays, D)."""
    if masks is not None:
        weights = jnp.where(masks, weights, 0.0)
    if values is None:
        return jnp.sum(weights, axis=1, keepdims=True)
    return jnp.einsum("rk,rkd->rd", weights, values)


def rendering_dense(
    t_starts,
    t_ends,
    masks,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Render rays on the dense (n_rays, K) layout (fast-path twin of
    :func:`rendering`; same math as reference ``vol_rendering.py:15-129``).

    The field callback receives dense ``(t_starts, t_ends)`` of shape
    (n_rays, K) and must return ``rgbs (n_rays, K, 3)`` and ``sigmas`` (or
    alphas) of shape (n_rays, K).
    """
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be "
            "specified."
        )
    t_starts = jax.lax.stop_gradient(t_starts)
    t_ends = jax.lax.stop_gradient(t_ends)
    if rgb_sigma_fn is not None:
        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends)
        weights = render_weight_from_density_dense(
            t_starts, t_ends, sigmas, masks=masks
        )
    else:
        rgbs, alphas = rgb_alpha_fn(t_starts, t_ends)
        weights = render_weight_from_alpha_dense(alphas, masks=masks)

    colors = accumulate_along_rays_dense(weights, values=rgbs, masks=masks)
    opacities = accumulate_along_rays_dense(weights, masks=masks)
    t_mid = (t_starts + t_ends) / 2.0
    depths = accumulate_along_rays_dense(
        weights, values=t_mid[..., None], masks=masks
    )
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths


# ---------------------------------------------------------------------------
# Public API (reference vol_rendering.py signatures + `masks` for the
# fixed-capacity layout)
# ---------------------------------------------------------------------------


def render_transmittance_from_density(
    t_starts,
    t_ends,
    sigmas,
    *,
    packed_info=None,
    ray_indices=None,
    n_rays: Optional[int] = None,
    masks=None,
):
    """Transmittance ``T_i = exp(-sum_{j<i} sigma_j delta_j)`` per sample.

    Mirrors reference ``vol_rendering.py:201-266``. ``masks`` marks valid
    packed entries (invalid ones are treated as vacuum).
    """
    sig, had = _flatten(sigmas)
    ts, _ = _flatten(t_starts)
    te, _ = _flatten(t_ends)
    dl = _detect_dense_layout(ray_indices, packed_info, sig.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        out = render_transmittance_from_density_dense(
            ts.reshape(R, K), te.reshape(R, K), sig.reshape(R, K), masks=m2
        ).reshape(-1)
        return _reshape_like(out, had)
    ray_indices, n_rays = _resolve_indices(
        ray_indices, packed_info, sig.shape[0], n_rays
    )
    deltas = te - ts
    if masks is not None:
        m, _ = _flatten(masks)
        sig = jnp.where(m, sig, 0.0)
        deltas = jnp.where(m, deltas, 0.0)
    out = _trans_from_density(sig, deltas, ray_indices, n_rays)
    return _reshape_like(out, had)


def render_transmittance_from_alpha(
    alphas,
    *,
    packed_info=None,
    ray_indices=None,
    n_rays: Optional[int] = None,
    masks=None,
):
    """Transmittance ``T_i = prod_{j<i} (1 - alpha_j)`` per sample.

    Mirrors reference ``vol_rendering.py:269-323``.
    """
    a, had = _flatten(alphas)
    dl = _detect_dense_layout(ray_indices, packed_info, a.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        out = render_transmittance_from_alpha_dense(
            a.reshape(R, K), masks=m2
        ).reshape(-1)
        return _reshape_like(out, had)
    ray_indices, n_rays = _resolve_indices(
        ray_indices, packed_info, a.shape[0], n_rays
    )
    if masks is not None:
        m, _ = _flatten(masks)
        a = jnp.where(m, a, 0.0)
    out = _trans_from_alpha(a, ray_indices, n_rays)
    return _reshape_like(out, had)


def render_weight_from_density(
    t_starts,
    t_ends,
    sigmas,
    *,
    packed_info=None,
    ray_indices=None,
    n_rays: Optional[int] = None,
    masks=None,
):
    """Rendering weights ``w_i = T_i (1 - exp(-sigma_i delta_i))``.

    Mirrors reference ``vol_rendering.py:326-393``.
    """
    sig, had = _flatten(sigmas)
    ts, _ = _flatten(t_starts)
    te, _ = _flatten(t_ends)
    dl = _detect_dense_layout(ray_indices, packed_info, sig.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        out = render_weight_from_density_dense(
            ts.reshape(R, K), te.reshape(R, K), sig.reshape(R, K), masks=m2
        ).reshape(-1)
        return _reshape_like(out, had)
    ray_indices, n_rays = _resolve_indices(
        ray_indices, packed_info, sig.shape[0], n_rays
    )
    deltas = te - ts
    if masks is not None:
        m, _ = _flatten(masks)
        sig = jnp.where(m, sig, 0.0)
        deltas = jnp.where(m, deltas, 0.0)
    out = _weight_from_density(sig, deltas, ray_indices, n_rays)
    return _reshape_like(out, had)


def render_weight_from_alpha(
    alphas,
    *,
    packed_info=None,
    ray_indices=None,
    n_rays: Optional[int] = None,
    masks=None,
):
    """Rendering weights ``w_i = T_i alpha_i``.

    Mirrors reference ``vol_rendering.py:396-449``.
    """
    a, had = _flatten(alphas)
    dl = _detect_dense_layout(ray_indices, packed_info, a.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        out = render_weight_from_alpha_dense(
            a.reshape(R, K), masks=m2
        ).reshape(-1)
        return _reshape_like(out, had)
    ray_indices, n_rays = _resolve_indices(
        ray_indices, packed_info, a.shape[0], n_rays
    )
    if masks is not None:
        m, _ = _flatten(masks)
        a = jnp.where(m, a, 0.0)
    out = _weight_from_alpha(a, ray_indices, n_rays)
    return _reshape_like(out, had)


def render_visibility(
    alphas,
    *,
    packed_info=None,
    ray_indices=None,
    n_rays: Optional[int] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
    masks=None,
):
    """Boolean visibility per sample: ``T >= early_stop_eps`` and
    ``alpha >= alpha_thre`` (reference ``vol_rendering.py:452-520``).

    Not differentiable (a hard mask).
    """
    a, _ = _flatten(alphas)
    a = jax.lax.stop_gradient(a)
    dl = _detect_dense_layout(ray_indices, packed_info, a.shape[0], n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        return render_visibility_dense(
            a.reshape(R, K), masks=m2,
            early_stop_eps=early_stop_eps, alpha_thre=alpha_thre,
        ).reshape(-1)
    ray_indices, n_rays = _resolve_indices(
        ray_indices, packed_info, a.shape[0], n_rays
    )
    if masks is not None:
        m, _ = _flatten(masks)
        a = jnp.where(m, a, 0.0)
    trans = _trans_from_alpha(a, ray_indices, n_rays)
    vis = trans >= early_stop_eps
    if alpha_thre > 0:
        vis = vis & (a >= alpha_thre)
    if masks is not None:
        m, _ = _flatten(masks)
        vis = vis & m
    return vis


def accumulate_along_rays(
    weights,
    ray_indices,
    values=None,
    n_rays: Optional[int] = None,
    masks=None,
):
    """Accumulate ``sum_i w_i v_i`` per ray (reference
    ``vol_rendering.py:132-198``, a segment-sum instead of scatter_add).

    Args:
        weights: (n_samples,) or (n_samples, 1).
        ray_indices: (n_samples,) sorted.
        values: optional (n_samples, D); defaults to ones.
        n_rays: static ray count (required under jit; defaults to
            n_samples as a static upper bound).
        masks: optional validity; invalid samples contribute zero.

    Returns:
        (n_rays, D) accumulated values (D=1 when values is None).
    """
    w, _ = _flatten(weights)
    n_samples = w.shape[0]
    dl = _detect_dense_layout(ray_indices, None, n_samples, n_rays)
    if dl is not None:
        K, R = dl
        m2 = _flatten(masks)[0].reshape(R, K) if masks is not None else None
        v2 = (
            values.reshape(R, K, values.shape[-1])
            if values is not None
            else None
        )
        return accumulate_along_rays_dense(
            w.reshape(R, K), values=v2, masks=m2
        )
    if n_rays is None:
        n_rays = n_samples
    if values is not None:
        src = w[:, None] * values
    else:
        src = w[:, None]
    if masks is not None:
        m, _ = _flatten(masks)
        src = jnp.where(m[:, None], src, 0.0)
    return segment_sum(src, ray_indices.astype(jnp.int32), n_rays)


def rendering(
    t_starts,
    t_ends,
    ray_indices,
    n_rays: int,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd=None,
    masks=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Render rays through a radiance field (reference
    ``vol_rendering.py:15-129``).

    The field is supplied as a callback ``rgb_sigma_fn(t_starts, t_ends,
    ray_indices) -> (rgbs (N, 3), sigmas (N, 1))`` (or ``rgb_alpha_fn``
    returning opacities), exactly the reference contract. Differentiable to
    the callback outputs; not to ``t_starts``/``t_ends``.

    Returns:
        (colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1)).
    """
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be "
            "specified."
        )
    t_starts = jax.lax.stop_gradient(t_starts)
    t_ends = jax.lax.stop_gradient(t_ends)
    if rgb_sigma_fn is not None:
        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends, ray_indices)
        assert rgbs.shape[-1] == 3, f"rgbs must have 3 channels, got {rgbs.shape}"
        weights = render_weight_from_density(
            t_starts, t_ends, sigmas,
            ray_indices=ray_indices, n_rays=n_rays, masks=masks,
        )
    else:
        rgbs, alphas = rgb_alpha_fn(t_starts, t_ends, ray_indices)
        assert rgbs.shape[-1] == 3, f"rgbs must have 3 channels, got {rgbs.shape}"
        weights = render_weight_from_alpha(
            alphas, ray_indices=ray_indices, n_rays=n_rays, masks=masks,
        )

    colors = accumulate_along_rays(
        weights, ray_indices, values=rgbs, n_rays=n_rays, masks=masks
    )
    opacities = accumulate_along_rays(
        weights, ray_indices, values=None, n_rays=n_rays, masks=masks
    )
    t_mid = (_flatten(t_starts)[0] + _flatten(t_ends)[0]) / 2.0
    depths = accumulate_along_rays(
        weights, ray_indices, values=t_mid[:, None], n_rays=n_rays, masks=masks
    )

    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)

    return colors, opacities, depths
