"""Instant-NGP radiance field in JAX (re-creation of reference
``examples/radiance_fields/ngp.py`` without tinycudann).

Hash-grid encoder (:mod:`hash_encoding`) + small MLP heads; the
truncated-exp density activation reproduces torch-ngp's ``trunc_exp``
(clamped-exp backward, ``ngp.py:22-38``); ``contract_to_unisphere``
matches ``ngp.py:41-63`` (the MipNeRF-360 contraction mapped to [0,1]).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .hash_encoding import HashEncoder
from .module import Dense, Module


@jax.custom_vjp
def trunc_exp(x):
    # forward clamped at 30 (density 1e13) — the reference leaves the
    # forward unclamped (ngp.py:22-38) but an overflowed inf density
    # poisons masked-slot math (inf * 0 delta = NaN) in the dense layout;
    # measured blowing up the unbounded proposal run at lr 1e-2
    return jnp.exp(jnp.minimum(x, 30.0))


def _trunc_exp_fwd(x):
    return trunc_exp(x), x


def _trunc_exp_bwd(x, g):
    return (g * jnp.exp(jnp.minimum(x, 15.0)),)


trunc_exp.defvjp(_trunc_exp_fwd, _trunc_exp_bwd)


def contract_to_unisphere(x: jnp.ndarray, aabb: jnp.ndarray) -> jnp.ndarray:
    """MipNeRF-360 contraction into [0, 1]^3 (reference ``ngp.py:41-63``)."""
    aabb_min, aabb_max = aabb[:3], aabb[3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2 - 1
    mag = jnp.linalg.norm(x, axis=-1, keepdims=True)
    safe = jnp.maximum(mag, 1e-10)
    x = jnp.where(mag > 1, (2 - 1 / safe) * (x / safe), x)
    return x / 4 + 0.5


def spherical_harmonics_deg4(d: jnp.ndarray) -> jnp.ndarray:
    """Real SH basis, degrees 0-3 (16 coefficients), matching tcnn's
    ``SphericalHarmonics`` degree-4 direction encoding
    (reference ``ngp.py:92-106``). ``d`` must be unit vectors."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return jnp.stack(
        [
            0.28209479177387814 * jnp.ones_like(x),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        axis=-1,
    )


class _SmallMLP(Module):
    """tcnn-FullyFusedMLP-shaped head: n_hidden x 64, relu."""

    out_dim: int
    n_hidden: int = 1
    width: int = 64

    def __call__(self, x):
        for i in range(self.n_hidden):
            x = jax.nn.relu(
                self.child(f"Dense_{i}", Dense(self.width, use_bias=False))(x)
            )
        return self.child(
            f"Dense_{self.n_hidden}", Dense(self.out_dim, use_bias=False)
        )(x)


class NGPRadianceField(Module):
    """Instant-NGP field (reference ``ngp.py:66-197``).

    ``aabb`` is a static 6-tuple. Density outside the (contracted) unit
    cube is zeroed by the selector, like the reference (``ngp.py:153-165``).
    """

    aabb: tuple
    use_viewdirs: bool = True
    unbounded: bool = False
    geo_feat_dim: int = 15
    n_levels: int = 16
    n_features: int = 2  # 4 = round-5 capacity-preserving config (L=8)
    log2_hashmap_size: int = 19
    gather_mode: str = "packed"  # "per_level" = round-5 forward variant

    def _contract(self, x):
        aabb = jnp.asarray(self.aabb, jnp.float32)
        if self.unbounded:
            return contract_to_unisphere(x, aabb)
        return (x - aabb[:3]) / (aabb[3:] - aabb[:3])

    def query_density(self, x, return_feat: bool = False):
        x = self._contract(x)
        selector = jnp.all((x > 0.0) & (x < 1.0), axis=-1, keepdims=True)
        enc = self.child("encoder", HashEncoder(
            n_levels=self.n_levels,
            n_features=self.n_features,
            log2_hashmap_size=self.log2_hashmap_size,
            gather_mode=self.gather_mode,
        ))
        mlp_base = self.child(
            "mlp_base", _SmallMLP(1 + self.geo_feat_dim, n_hidden=1)
        )
        h = mlp_base(enc(x))
        density_before, feat = h[..., :1], h[..., 1:]
        density = trunc_exp(density_before - 1.0) * selector
        if return_feat:
            return density, feat
        return density

    def query_opacity(self, x, step_size):
        return self.query_density(x) * step_size

    def __call__(self, positions, directions=None):
        density, feat = self.query_density(positions, return_feat=True)
        if self.use_viewdirs and directions is not None:
            d = spherical_harmonics_deg4(directions)
            h = jnp.concatenate([d, feat], axis=-1)
        else:
            h = feat
        rgb = jax.nn.sigmoid(
            self.child("mlp_head", _SmallMLP(3, n_hidden=2))(h)
        )
        return rgb, density
