"""MLP radiance fields (re-creations of reference
``examples/radiance_fields/mlp.py``).

Vanilla NeRF (PE 10/4 degrees, 8x256 trunk with skip, view-conditioned rgb
branch) and the D-NeRF time-warped variant. Functional modules
(:mod:`.module`): params live in an external pytree, so replication,
sharding and checkpointing need nothing from the model.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .encoders import SinusoidalEncoder
from .module import Dense, Module, initializers

_dense = functools.partial(
    Dense,
    kernel_init=initializers.xavier_uniform(),
    bias_init=initializers.zeros,
)


class MLP(Module):
    """Skip-connected MLP (reference ``mlp.py:14-101``). Layers are
    ``Dense_0 .. Dense_{net_depth}``, the last one the output layer."""

    output_dim: Optional[int] = None
    net_depth: int = 8
    net_width: int = 256
    skip_layer: Optional[int] = 4
    hidden_activation: Callable = jax.nn.relu
    output_enabled: bool = True
    output_activation: Callable = lambda x: x
    output_kernel_init: Callable = initializers.xavier_uniform()

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        inputs = x
        for i in range(self.net_depth):
            x = self.child(f"Dense_{i}", _dense(self.net_width))(x)
            x = self.hidden_activation(x)
            if (
                self.skip_layer is not None
                and i % self.skip_layer == 0
                and i > 0
            ):
                x = jnp.concatenate([x, inputs], axis=-1)
        if self.output_enabled:
            x = self.child(
                f"Dense_{self.net_depth}",
                Dense(
                    self.output_dim,
                    kernel_init=self.output_kernel_init,
                    bias_init=initializers.zeros,
                ),
            )(x)
            x = self.output_activation(x)
        return x


class NerfMLP(Module):
    """Trunk + sigma head + view-conditioned rgb branch
    (reference ``mlp.py:114-165``)."""

    net_depth: int = 8
    net_width: int = 256
    skip_layer: Optional[int] = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128

    def base(self, x):
        return self.child("base", MLP(
            net_depth=self.net_depth,
            net_width=self.net_width,
            skip_layer=self.skip_layer,
            output_enabled=False,
        ))(x)

    def sigma_layer(self, h):
        return self.child("sigma_layer", _dense(1))(h)

    def query_density(self, x):
        return self.sigma_layer(self.base(x))

    def __call__(self, x, condition=None):
        h = self.base(x)
        raw_sigma = self.sigma_layer(h)
        if condition is not None:
            if condition.shape[:-1] != h.shape[:-1]:
                condition = jnp.broadcast_to(
                    condition[..., None, :],
                    h.shape[:-1] + (condition.shape[-1],),
                )
            bottleneck = self.child(
                "bottleneck_layer", _dense(self.net_width)
            )(h)
            h = jnp.concatenate([bottleneck, condition], axis=-1)
        raw_rgb = self.child("rgb_layer", MLP(
            output_dim=3,
            net_depth=self.net_depth_condition,
            net_width=self.net_width_condition,
            skip_layer=None,
        ))(h)
        return raw_rgb, raw_sigma


class VanillaNeRFRadianceField(Module):
    """Vanilla NeRF field (reference ``mlp.py:206-245``).

    Entry points (use ``model.apply(params, ..., method=...)``):
      * ``__call__(x, condition)`` -> (rgb, sigma), post-activation;
      * ``query_density(x)`` -> sigma;
      * ``query_opacity(x, step_size)`` -> density * step (the occupancy
        proxy used for grid updates, ``mlp.py:228-233``).
    """

    net_depth: int = 8
    net_width: int = 256
    skip_layer: int = 4
    net_depth_condition: int = 1
    net_width_condition: int = 128

    @property
    def mlp(self) -> NerfMLP:
        return self.child("mlp", NerfMLP(
            net_depth=self.net_depth,
            net_width=self.net_width,
            skip_layer=self.skip_layer,
            net_depth_condition=self.net_depth_condition,
            net_width_condition=self.net_width_condition,
        ))

    def query_opacity(self, x, step_size):
        return self.query_density(x) * step_size

    def query_density(self, x):
        xe = SinusoidalEncoder(3, 0, 10, True)(x)
        return jax.nn.relu(self.mlp.query_density(xe))

    def __call__(self, x, condition=None):
        xe = SinusoidalEncoder(3, 0, 10, True)(x)
        if condition is not None:
            condition = SinusoidalEncoder(3, 0, 4, True)(condition)
        rgb, sigma = self.mlp(xe, condition=condition)
        return jax.nn.sigmoid(rgb), jax.nn.relu(sigma)


class DNeRFRadianceField(Module):
    """Time-conditioned deformation field + vanilla NeRF
    (reference ``mlp.py:248-283``).

    ``warp_depth`` / ``warp_width`` / ``time_degree`` expose the warp
    head's capacity (reference defaults 4 / 64 / 4) for quality sweeps
    on scenes with large motion amplitudes.
    """

    warp_depth: int = 4
    warp_width: int = 64
    time_degree: int = 4

    @property
    def nerf(self) -> VanillaNeRFRadianceField:
        return self.child("nerf", VanillaNeRFRadianceField())

    def _warp(self, x, t):
        warp = self.child("warp", MLP(
            output_dim=3,
            net_depth=self.warp_depth,
            net_width=self.warp_width,
            skip_layer=2,
            output_kernel_init=initializers.uniform(scale=1e-4),
        ))
        return x + warp(
            jnp.concatenate(
                [
                    SinusoidalEncoder(3, 0, 4, True)(x),
                    SinusoidalEncoder(1, 0, self.time_degree, True)(t),
                ],
                axis=-1,
            )
        )

    def warp_displacement(self, x, t):
        """The warp's displacement w(x, t) - x — exposed for
        regularizers (the monocular D-NeRF setting has one view per
        timestamp, so an unconstrained warp can memorize per-timestamp
        appearance; magnitude/temporal-smoothness penalties keep it
        interpolating — round-4 D-NeRF stability work)."""
        return self._warp(x, t) - x

    def query_opacity(self, x, timestamps, step_size, key):
        idxs = jax.random.randint(key, (x.shape[0],), 0, timestamps.shape[0])
        t = timestamps[idxs]
        return self.query_density(x, t) * step_size

    def query_density(self, x, t):
        return self.nerf.query_density(self._warp(x, t))

    def __call__(self, x, t, condition=None):
        return self.nerf(self._warp(x, t), condition=condition)
