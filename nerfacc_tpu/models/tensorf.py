"""Tensor-factorized radiance field — an Instant-NGP-class model.

The locality NGP gets from a hash table can also come from a *tensor
factorization* with a local (hat / linear-interpolation) basis evaluated
densely:

    feature_r(x, y, z) = u_r(x) * v_r(y) * w_r(z)      (CP decomposition)
    u_r(x) = hat(x) @ U[:, r]                           (dense matmul)

``hat(x)`` is the (B, G) linear-interpolation basis — exactly 2 adjacent
nonzeros per row, built with an iota compare and contracted by a matrix
product. Gradients w.r.t. the factor tables are ``hat(x)^T @ dU`` — also a
matmul. No gathers and no scatters, in forward *and* backward, at G/2
times the FLOPs of a two-row gather; parameter updates remain local (each
sample touches 2 rows per axis per level), which is what makes NGP-class
models converge in ~20k steps.

Multiple resolution levels (coarse-to-fine, like NGP's level pyramid) are
concatenated. Heads mirror the reference NGP example
(``examples/radiance_fields/ngp.py:108-165``): trunc_exp density with a
geometric feature, SH-deg-4 view encoding, small MLP heads.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from .module import Dense, Module, initializers
from .ngp import contract_to_unisphere, spherical_harmonics_deg4, trunc_exp


def hat_basis(x: jnp.ndarray, grid_size: int) -> jnp.ndarray:
    """Dense linear-interpolation (hat) basis over a 1D grid.

    Args:
        x: (B,) coordinates in [0, 1].
        grid_size: number of grid nodes G (align-corners: node i at
            ``i / (G - 1)``).

    Returns:
        (B, G) basis, rows are a partition of unity with exactly two
        adjacent nonzeros.
    """
    u = x * (grid_size - 1)
    nodes = jnp.arange(grid_size, dtype=x.dtype)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(u[:, None] - nodes))


@jax.custom_vjp
def _hat_matmul_int8(u: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """``hat(u) @ table`` with the forward contraction in int8.

    The hat basis takes values in [0, 1]; quantizing it to int8 rounds the
    interpolation weight to 1/127 of a voxel — a positional perturbation
    far below the sampling step. The table quantizes per-column to its
    abs-max. An int8 x int8 -> int32 product has twice the bf16 peak rate
    on tensor cores, and a materialized (B, G) basis operand shrinks to
    1 byte/element.

    The backward is the exact bf16 formulation with f32 accumulation:
    ``d_table = hat(u)^T @ g`` (same math as autodiff of the bf16 path);
    ``u`` is positional and gets a zero cotangent (sampling is
    stop-gradient throughout this framework).
    """
    G = table.shape[0]
    # integer basis build: one per-sample rounding v = rint(127 u), then
    # 127 * hat(v / 127) = max(0, 127 - |v - 127 j|) exactly — int8 rows
    # still sum to exactly 127 (partition of unity preserved), and the op
    # count per element matches the f32 basis (no extra round/cast pass)
    v = jnp.rint(u * 127.0).astype(jnp.int32)
    nodes127 = jax.lax.broadcasted_iota(jnp.int32, (u.shape[0], G), 1) * 127
    bq = jnp.maximum(0, 127 - jnp.abs(v[:, None] - nodes127)).astype(
        jnp.int8
    )
    s_t = jnp.max(jnp.abs(table), axis=0, keepdims=True) / 127.0  # (1, R)
    tq = jnp.rint(table / jnp.maximum(s_t, 1e-20)).astype(jnp.int8)
    acc = jax.lax.dot_general(
        bq, tq,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * (s_t / 127.0)


def _hat_matmul_int8_fwd(u, table):
    return _hat_matmul_int8(u, table), (u, table.shape[0])


def _hat_matmul_int8_bwd(res, g):
    u, G = res
    nodes = jax.lax.broadcasted_iota(jnp.int32, (u.shape[0], G), 1).astype(
        u.dtype
    )
    basis = jnp.maximum(0.0, 1.0 - jnp.abs(u[:, None] - nodes))
    d_table = jax.lax.dot_general(
        basis.astype(jnp.bfloat16), g.astype(jnp.bfloat16),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jnp.zeros_like(u), d_table


_hat_matmul_int8.defvjp(_hat_matmul_int8_fwd, _hat_matmul_int8_bwd)


class CPLevel(Module):
    """One CP level: 3 axis tables (G, R); features are per-axis hat-matmul
    results multiplied elementwise, in ``dtype``."""

    grid_size: int
    rank: int
    init_scale: float = 0.2
    quant_int8: bool = False
    dtype: Any = jnp.bfloat16

    @jax.named_scope("cp_level")
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        # x: (B, 3) in [0, 1]^3 -> (B, rank)
        tables = [
            self.param(
                f"axis{axis}",
                initializers.normal(self.init_scale),
                (self.grid_size, self.rank),
            )
            for axis in range(3)
        ]
        if self.quant_int8:
            # int8 forward contraction, exact bf16 backward — see
            # _hat_matmul_int8. The axis-feature product stays in dtype
            # like the default path so downstream fusions are unchanged.
            feats = None
            for axis in range(3):
                u = _hat_matmul_int8(
                    x[:, axis] * (self.grid_size - 1), tables[axis]
                ).astype(self.dtype)
                feats = u if feats is None else feats * u
            return feats
        feats = None
        for axis in range(3):
            basis = hat_basis(x[:, axis], self.grid_size).astype(self.dtype)
            # bf16 end to end by default: features feed bf16 heads anyway
            u = jnp.dot(
                basis, tables[axis].astype(self.dtype),
                preferred_element_type=self.dtype,
            )
            feats = u if feats is None else feats * u
        return feats


class _HeadMLP(Module):
    """Small MLP head (tcnn-FullyFusedMLP-shaped, 64 wide), computed in
    ``dtype`` with float32 parameters."""

    out_dim: int
    n_hidden: int = 1
    width: int = 64
    dtype: Any = jnp.bfloat16

    def __call__(self, x):
        x = x.astype(self.dtype)
        for i in range(self.n_hidden):
            h = self.child(
                f"Dense_{i}",
                Dense(self.width, use_bias=False, dtype=self.dtype),
            )(x)
            x = jax.nn.relu(h)
        return self.child(
            f"Dense_{self.n_hidden}",
            Dense(self.out_dim, use_bias=False, dtype=self.dtype),
        )(x).astype(jnp.float32)


class TensoCPRadianceField(Module):
    """NGP-class radiance field on CP-factorized feature volumes.

    API-compatible with :class:`~nerfacc_tpu.models.NGPRadianceField`
    (``query_density`` / ``query_opacity`` / ``__call__``); density outside
    the (contracted) unit cube is zeroed by the selector like the reference
    (``ngp.py:153-165``). ``compute_dtype`` is the features' and heads'
    dtype: bf16 for training, float32 for the reference it is checked
    against.
    """

    aabb: Tuple[float, ...]
    levels: Tuple[Tuple[int, int], ...] = ((128, 64), (512, 128))
    use_viewdirs: bool = True
    unbounded: bool = False
    geo_feat_dim: int = 15
    quant_int8: bool = False
    # initial log-density shift: density ~ trunc_exp(bias) at init. The
    # default -1 (density ~0.37) is fine for bounded scenes (~3 units of
    # ray path) but leaves unbounded rays (~12+ units) near-opaque at
    # init, which stalls early training — use a lower bias there.
    density_bias: float = -1.0
    compute_dtype: Any = jnp.bfloat16

    def _contract(self, x):
        aabb = jnp.asarray(self.aabb, jnp.float32)
        if self.unbounded:
            return contract_to_unisphere(x, aabb)
        return (x - aabb[:3]) / (aabb[3:] - aabb[:3])

    def _encode(self, xu):
        return jnp.concatenate(
            [
                self.child(
                    f"level{i}",
                    CPLevel(
                        grid_size=g, rank=r, quant_int8=self.quant_int8,
                        dtype=self.compute_dtype,
                    ),
                )(xu)
                for i, (g, r) in enumerate(self.levels)
            ],
            axis=-1,
        )

    def query_density(self, x, return_feat: bool = False):
        xu = self._contract(x)
        selector = jnp.all((xu > 0.0) & (xu < 1.0), axis=-1, keepdims=True)
        xq = jnp.clip(xu, 0.0, 1.0)
        mlp_base = self.child(
            "mlp_base",
            _HeadMLP(1 + self.geo_feat_dim, n_hidden=1,
                     dtype=self.compute_dtype),
        )
        h = mlp_base(self._encode(xq))
        density_before, feat = h[..., :1], h[..., 1:]
        density = trunc_exp(density_before + self.density_bias) * selector
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
            self.child(
                "mlp_head", _HeadMLP(3, n_hidden=2, dtype=self.compute_dtype)
            )(h)
        )
        return rgb, density
