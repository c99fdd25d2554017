"""Scene contractions (pure jnp).

Re-implements the three coordinate contractions of the reference toolbox
(see reference ``nerfacc/contraction.py`` and
``nerfacc/cuda/csrc/include/helpers_contraction.h:16-129``) as vectorized
jnp functions. No kernels are needed: these are bandwidth-trivial
elementwise ops that XLA fuses into their consumers.

Conventions (identical to the reference):
  - ``AABB``: roi -> [0, 1]^3 linear map.
  - ``UN_BOUNDED_TANH``: [-inf, inf]^3 -> [0, 1]^3, roi -> [0.25, 0.75]^3
    via per-axis tanh.
  - ``UN_BOUNDED_SPHERE``: MipNeRF-360 contraction. [-inf, inf]^3 -> unit
    sphere in [0, 1]^3; roi maps into the sphere of [0.25, 0.75]^3.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class ContractionType(enum.Enum):
    """How a world-space point is mapped into the unit grid cube.

    Mirrors the reference enum (``helpers_contraction.h:9-14``).
    """

    AABB = 0
    UN_BOUNDED_TANH = 1
    UN_BOUNDED_SPHERE = 2

    def to_cpp_version(self):  # API parity shim; there is no C++ layer.
        return self.value


def _split_roi(roi: jnp.ndarray):
    roi = jnp.asarray(roi, dtype=jnp.float32)
    return roi[..., :3], roi[..., 3:]


def _roi_to_unit(x, roi_min, roi_max):
    return (x - roi_min) / (roi_max - roi_min)


def _unit_to_roi(x, roi_min, roi_max):
    return x * (roi_max - roi_min) + roi_min


def contract(
    x: jnp.ndarray,
    roi: jnp.ndarray,
    type: ContractionType = ContractionType.AABB,
) -> jnp.ndarray:
    """Contract world-space points into the unit cube ``[0, 1]^3``.

    Args:
        x: (..., 3) world-space points.
        roi: (6,) region of interest ``{minx, miny, minz, maxx, maxy, maxz}``.
        type: the contraction to apply.

    Returns:
        (..., 3) contracted points.
    """
    roi_min, roi_max = _split_roi(roi)
    x = jnp.asarray(x)
    if type == ContractionType.AABB:
        return _roi_to_unit(x, roi_min, roi_max)
    elif type == ContractionType.UN_BOUNDED_TANH:
        u = _roi_to_unit(x, roi_min, roi_max) - 0.5
        return jnp.tanh(u) * 0.5 + 0.5
    elif type == ContractionType.UN_BOUNDED_SPHERE:
        u = _roi_to_unit(x, roi_min, roi_max) * 2.0 - 1.0  # roi -> [-1, 1]^3
        norm = jnp.linalg.norm(u, axis=-1, keepdims=True)
        safe_norm = jnp.maximum(norm, 1e-10)
        contracted = (2.0 - 1.0 / safe_norm) * (u / safe_norm)
        u = jnp.where(norm > 1.0, contracted, u)
        return u * 0.25 + 0.5  # [-2, 2]^3 ball -> [0, 1]^3 ball
    else:
        raise ValueError(f"Unknown contraction type: {type}")


def contract_inv(
    x: jnp.ndarray,
    roi: jnp.ndarray,
    type: ContractionType = ContractionType.AABB,
) -> jnp.ndarray:
    """Recover world-space points from contracted coordinates.

    Inverse of :func:`contract` (reference ``helpers_contraction.h:42-99``).
    """
    roi_min, roi_max = _split_roi(roi)
    x = jnp.asarray(x)
    if type == ContractionType.AABB:
        return _unit_to_roi(x, roi_min, roi_max)
    elif type == ContractionType.UN_BOUNDED_TANH:
        u = jnp.clip(jnp.arctanh(x * 2.0 - 1.0), -1e10, 1e10) + 0.5
        return _unit_to_roi(u, roi_min, roi_max)
    elif type == ContractionType.UN_BOUNDED_SPHERE:
        u = (x - 0.5) * 4.0  # [0.25, 0.75]^3 -> [-1, 1]^3
        norm_sq = jnp.sum(u * u, axis=-1, keepdims=True)
        norm = jnp.sqrt(norm_sq)
        expanded = u / jnp.maximum(2.0 * norm - norm_sq, 1e-10)
        u = jnp.where(norm > 1.0, expanded, u)
        u = u * 0.5 + 0.5
        return _unit_to_roi(u, roi_min, roi_max)
    else:
        raise ValueError(f"Unknown contraction type: {type}")
