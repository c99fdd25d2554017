"""Input encoders.

Sinusoidal positional encoding as used by vanilla NeRF (re-creation of
reference ``examples/radiance_fields/mlp.py:168-203``). The multi-level
hash encoding lives in :mod:`nerfacc_tpu.models.hash_encoding`.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from .module import Module


class SinusoidalEncoder(Module):
    """NeRF positional encoding: ``[x, sin(2^i x), cos(2^i x)] for i in
    [min_deg, max_deg)``."""

    x_dim: int
    min_deg: int
    max_deg: int
    use_identity: bool = True

    @property
    def latent_dim(self) -> int:
        return (
            int(self.use_identity) + (self.max_deg - self.min_deg) * 2
        ) * self.x_dim

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.max_deg == self.min_deg:
            return x
        scales = jnp.asarray(
            [2**i for i in range(self.min_deg, self.max_deg)], dtype=x.dtype
        )
        xb = (x[..., None, :] * scales[:, None]).reshape(
            x.shape[:-1] + ((self.max_deg - self.min_deg) * self.x_dim,)
        )
        latent = jnp.sin(jnp.concatenate([xb, xb + 0.5 * math.pi], axis=-1))
        if self.use_identity:
            latent = jnp.concatenate([x, latent], axis=-1)
        return latent
