"""Hash-table encoder core op: multi-level gather forward + scatter backward.

The reference's NGP example leans on tcnn's fused hash-grid CUDA kernel
(``examples/radiance_fields/ngp.py:108-126``): forward is a per-thread
gather, backward a global-memory ``atomicAdd`` scatter.

Here the forward is one XLA gather of bf16 feature pairs packed into u32
words (``_pack_table_u32``) over the flat ``(N, L*8)`` corner layout,
blended by a corner-sum matmul; the backward is a per-level scatter-add,
which XLA lowers on the GPU to atomic adds — the same operation as tcnn's
``atomicAdd``, summing in a different order on each run.

The packing, the strict 2-D ``(N, L*8)`` layouts, the corner-sum matmul
and the per-level split of the backward were chosen for an earlier
accelerator's costs and are kept as written until a profiler trace on
the GPU decides between them and their plain forms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4))
def hash_encode_lookup(
    table, flat_idx, corner_w, n_entries_per_level, packed_gather=True,
):
    """Multi-level hash-table lookup + trilinear blend, with a custom
    backward that produces ONLY the table gradient.

    Args:
        table: (F * L * T,) f32 FLAT feature-major tables (F = 2 or 4):
            ``[:L*T]`` is feature 0 of all levels, ``[L*T:2*L*T]``
            feature 1, and so on (T entries per level).
        flat_idx: (N, L * 8) int32 indices into one feature's ``(L*T,)``
            slice (level offsets already added; level l's corners at
            columns ``l * 8 .. l * 8 + 8``).
        corner_w: (N, L * 8) f32 trilinear corner weights, same layout.
        n_entries_per_level: static T.
        packed_gather: gather bf16-packed feature pairs (one u32 gather
            instead of two f32 gathers; tcnn-equivalent fp16-class table
            reads), ``"per_level"`` for the same reads as L gathers over
            per-level slices, or False for full-f32 reads, two gathers.

    Returns:
        (N, F * L) f32 blended features, feature-major: columns
        ``[:L]`` are feature 0 of every level, ``[L:2L]`` feature 1, ...
        The order is a fixed permutation of the reference's interleaved
        layout — downstream MLPs learn under any fixed order.

    The backward returns a ``float0``-style zero for ``flat_idx`` (int
    primal) and zeros for ``corner_w`` — sample positions are
    stop-gradient throughout this framework (sampling is
    non-differentiable). vs the
    reference: tcnn's encoder backward is the same table-only scatter
    (``atomicAdd`` per corner); positions get no gradient there either
    when the input is detached (the NGP example's usage).
    """
    L = flat_idx.shape[1] // 8
    n_features = table.shape[0] // (L * n_entries_per_level)
    return _lookup_fwd_impl(
        table, flat_idx, corner_w, packed_gather, n_features
    )


def _corner_sum_matrix(L: int) -> jnp.ndarray:
    """(L*8, L) 0/1 matrix summing each level's 8 corner columns: the
    8-corner reduction ``reshape(N, L, 8).sum(-1)`` as one 2-D matmul."""
    cols = jnp.arange(L * 8) // 8
    return (cols[:, None] == jnp.arange(L)[None, :]).astype(jnp.float32)


def _pack_pair(f0, f1):
    """Two (M,) f32 feature columns -> (M,) u32 of packed bf16 pairs."""
    hi = jax.lax.shift_left(
        jax.lax.bitcast_convert_type(
            f0.astype(jnp.bfloat16), jnp.uint16
        ).astype(jnp.uint32),
        jnp.uint32(16),
    )
    lo = jax.lax.bitcast_convert_type(
        f1.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    return hi | lo


def _pack_table_u32(table):
    """(2*L*T,) f32 feature-major -> (L*T,) u32 of packed bf16 pairs.

    Feature 0 goes to the high 16 bits and feature 1 to the low, so one
    gather reads both. bf16 table reads match tcnn's fp16-table precision
    model (its CUDA kernels read __half); the master parameter and the
    adam update stay f32.
    """
    LT = table.shape[0] // 2
    f0 = table[:LT].astype(jnp.bfloat16)
    f1 = table[LT:].astype(jnp.bfloat16)
    hi = jax.lax.shift_left(
        jax.lax.bitcast_convert_type(f0, jnp.uint16).astype(jnp.uint32),
        jnp.uint32(16),
    )
    lo = jax.lax.bitcast_convert_type(f1, jnp.uint16).astype(jnp.uint32)
    return hi | lo


def _unpack_u32(g):
    """(…,) u32 packed pairs -> two f32 arrays (feature 0, feature 1)."""
    hi = jax.lax.bitcast_convert_type(
        jax.lax.shift_right_logical(g, jnp.uint32(16)).astype(jnp.uint16),
        jnp.bfloat16,
    ).astype(jnp.float32)
    lo = jax.lax.bitcast_convert_type(
        (g & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    return hi, lo


@jax.named_scope("hash_encode")
def _lookup_fwd_impl(table, flat_idx, corner_w, packed_gather=True,
                     n_features=2):
    N, L8 = flat_idx.shape
    L = L8 // 8
    LT = table.shape[0] // n_features
    S = _corner_sum_matrix(L)
    if n_features == 4:
        # F=4: two bf16-packed u32 gathers per corner over the same
        # index set — per feature the gather count matches F=2, so
        # L=8/F=4 carries the full 32-feature capacity with half the
        # corners of L=16/F=2
        packs = [
            _pack_pair(
                table[2 * p * LT:(2 * p + 1) * LT],
                table[(2 * p + 1) * LT:(2 * p + 2) * LT],
            )
            for p in range(2)
        ]
        flat_idx, corner_w, p0, p1 = jax.lax.optimization_barrier(
            (flat_idx, corner_w, packs[0], packs[1])
        )
        f0, f1 = _unpack_u32(p0[flat_idx])
        f2, f3 = _unpack_u32(p1[flat_idx])
        return jnp.concatenate(
            [
                jnp.dot(f * corner_w, S, preferred_element_type=jnp.float32)
                for f in (f0, f1, f2, f3)
            ],
            axis=1,
        )  # (N, 4L) feature-major
    if packed_gather == "per_level":
        # L gathers over (T,) slices of the packed table, reusing the
        # backward's (L, 8N) transpose-reshape layout
        T = LT // L
        packed = _pack_table_u32(table.astype(jnp.float32))  # (L*T,) u32
        flat_idx, corner_w, packed = jax.lax.optimization_barrier(
            (flat_idx, corner_w, packed)
        )
        idx_l = flat_idx.T.reshape(L, 8 * N)
        off = jnp.arange(L, dtype=jnp.int32)[:, None] * jnp.int32(T)
        idx_l = idx_l - off  # [0, T) per level
        g_l = [
            jax.lax.dynamic_slice_in_dim(packed, level * T, T)[idx_l[level]]
            for level in range(L)
        ]
        g = jnp.stack(g_l).reshape(L * 8, N).T  # (N, L*8)
        f0, f1 = _unpack_u32(g)
    elif packed_gather:
        packed = _pack_table_u32(table.astype(jnp.float32))  # (L*T,) u32
        # fusion firewall: keep the index computation out of the gather
        # op, and the packed table build from being re-fused per consumer
        flat_idx, corner_w, packed = jax.lax.optimization_barrier(
            (flat_idx, corner_w, packed)
        )
        g = packed[flat_idx]  # ONE (N, L*8) u32 gather, both features
        f0, f1 = _unpack_u32(g)
    else:
        tf = table.astype(jnp.float32)
        flat_idx, corner_w = jax.lax.optimization_barrier(
            (flat_idx, corner_w)
        )
        f0 = tf[:LT][flat_idx]
        f1 = tf[LT:][flat_idx]
    out0 = jnp.dot(f0 * corner_w, S, preferred_element_type=jnp.float32)
    out1 = jnp.dot(f1 * corner_w, S, preferred_element_type=jnp.float32)
    return jnp.concatenate([out0, out1], axis=1)  # (N, 2L)


def _lookup_fwd(table, flat_idx, corner_w, n_entries_per_level, packed_gather):
    L = flat_idx.shape[1] // 8
    n_features = table.shape[0] // (L * n_entries_per_level)
    out = _lookup_fwd_impl(
        table, flat_idx, corner_w, packed_gather, n_features
    )
    return out, (flat_idx, corner_w, table.shape)


@jax.named_scope("hash_table_grad")
def _bwd_scatter(flat_idx, corner_w, g, table_shape):
    """Table gradient via per-level scatter-adds (the F features share
    each level's index set).

    ``g`` is the (N, F*L) feature-major cotangent; the broadcast of each
    level's cotangent over its 8 corners is a matmul with the transposed
    corner-sum matrix. The per-level corner streams are carved out of one
    (L, 8N) transpose-reshape of the (N, L*8) arrays.
    """
    N, L8 = flat_idx.shape
    L = L8 // 8
    F = g.shape[1] // L  # feature count (2 or 4)
    LT = table_shape[0] // F
    T = LT // L
    St = _corner_sum_matrix(L).T  # (L, L*8)
    # same fusion firewall as the forward: keep the producer out of the
    # scatter's fusion
    vs = [
        (corner_w * jnp.dot(
            g[:, f * L:(f + 1) * L], St,
            preferred_element_type=jnp.float32,
        ))
        for f in range(F)
    ]
    barrier = jax.lax.optimization_barrier((flat_idx, *vs))
    idx, vs = barrier[0], barrier[1:]
    # (N, L*8) -> (L*8, N) -> (L, 8N): level l's corner stream is row l
    idx_l = idx.T.reshape(L, 8 * N)
    v_l = [v.T.reshape(L, 8 * N) for v in vs]
    off = jnp.arange(L, dtype=jnp.int32)[:, None] * jnp.int32(T)
    idx_l = idx_l - off  # strip the level offset -> [0, T)
    # the F per-level scatters share one index set and are issued
    # adjacently
    gs = [[] for _ in range(F)]
    for level in range(L):
        for f in range(F):
            gs[f].append(
                jnp.zeros((T,), jnp.float32).at[idx_l[level]].add(
                    v_l[f][level]
                )
            )
    return jnp.concatenate([x for f in range(F) for x in gs[f]])


def _lookup_bwd(n_entries_per_level, packed_gather, res, g):
    flat_idx, corner_w, table_shape = res
    d_table = _bwd_scatter(
        flat_idx, corner_w, g.astype(jnp.float32), table_shape
    )
    # int primal gets a float0 zero (JAX's convention for non-float
    # primals — cf. vol_rendering._int_zero_cotangent); corner_w is
    # stop-gradient by design.
    zero_idx = jax.custom_derivatives.zero_from_primal(
        flat_idx, symbolic_zeros=False
    )
    return (d_table, zero_idx, jnp.zeros_like(corner_w))


hash_encode_lookup.defvjp(_lookup_fwd, _lookup_bwd)


def hash_encode_reference(table, flat_idx, corner_w, n_entries_per_level):
    """Plain float32 form of :func:`hash_encode_lookup`: one gather per
    feature and a reshape-sum over each level's 8 corners, differentiated
    by autodiff (its table gradient is the scatter-add ``.at[].add``).
    The reference the custom-VJP path is checked against."""
    N, L8 = flat_idx.shape
    L = L8 // 8
    LT = L * n_entries_per_level
    F = table.shape[0] // LT
    table = table.astype(jnp.float32)
    return jnp.concatenate(
        [
            (table[f * LT + flat_idx] * corner_w).reshape(N, L, 8).sum(-1)
            for f in range(F)
        ],
        axis=1,
    )
