"""Multi-chip scale-out (SPMD over a device mesh).

The reference is single-GPU (SURVEY §2.5: no distributed anything); this
module is new design. Rays are embarrassingly parallel and packed samples
never cross a ray boundary, so the whole render path runs with **zero
communication** under a ray-sharded layout:

  * mesh: 1-D ``('data',)`` over all devices (multi-host included — same
    program; the GPUs of one host are joined all to all by NVLink, so the
    mesh needs no shape beyond the algorithm's one axis);
  * ray batches sharded on 'data'; radiance-field params + occupancy grid
    replicated;
  * the only collectives: ``psum`` of field gradients / losses, and a
    ``pmax`` merge for occupancy-grid EMA updates (NCCL on GPUs).

``data_parallel`` wraps a per-shard step function with ``shard_map`` so the
inner segment-scan machinery sees purely local buffers (local ray count,
local packed budget) — no cross-device gathers are ever generated.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None, axis: str = "data"
) -> Mesh:
    """1-D mesh over all (or given) devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicate(tree, mesh: Mesh):
    """Place a pytree fully replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Shard a pytree of batched arrays along their leading axis."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.device_put(tree, sharding)


def psum_grads(grads, axis="data"):
    """All-reduce gradients over the mesh axis. ``axis`` may
    be a tuple of axis names for hierarchical host x chip meshes
    (see :mod:`nerfacc_tpu.parallel.multihost`)."""
    return jax.lax.psum(grads, axis_name=axis)


def data_parallel(
    step_fn: Callable,
    mesh: Mesh,
    axis="data",
    *,
    batched_args: Sequence[int],
    n_out: int,
    replicated_out: Sequence[int] = (),
):
    """shard_map a per-shard step over ray batches.

    Args:
        step_fn: ``step_fn(*args) -> tuple of n_out arrays``; positional
            args at indices in ``batched_args`` are sharded on their
            leading axis, the rest replicated. Inside, ``step_fn`` sees
            local shards and may use ``jax.lax.psum(..., axis_name=axis)``
            (e.g. via :func:`psum_grads`) to combine gradients/metrics.
        n_out: number of outputs (declared rather than traced — the step
            may contain collectives, which cannot be shape-evaluated
            outside the mesh context).
        replicated_out: indices of outputs that are replicated (e.g. psum'd
            grads/losses); the rest are treated as batched (per-ray outputs,
            concatenated on the leading axis).

    Returns:
        A jitted SPMD function with the same signature.
    """
    rep = set(replicated_out)
    out_specs = tuple(
        P() if i in rep else P(axis) for i in range(n_out)
    )

    def wrapper(*args):
        in_specs = tuple(
            P(axis) if i in set(batched_args) else P()
            for i in range(len(args))
        )
        return jax.shard_map(
            step_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=out_specs if n_out > 1 else out_specs[0],
            check_vma=False,
        )(*args)

    return jax.jit(wrapper)


def update_grid_distributed(
    grid,
    key: jax.Array,
    step: int,
    occ_eval_fn: Callable,
    axis: str = "data",
    **kwargs,
):
    """Occupancy-grid EMA update under data parallelism (call inside
    ``shard_map``; the grid is replicated).

    Each device samples a *different* cell subset (the PRNG key is folded
    with the device's mesh index), evaluates the local field replica, and the
    per-cell EMA estimates merge with a ``pmax`` — matching the reference's
    ``occs = max(occs * decay, occ)`` semantics (``grid.py:232``) while
    multiplying the effective cells-per-update by the device count. The only
    other collective in training remains the gradient ``psum``.
    """
    from ..grid import update_grid, with_binary

    local_key = jax.random.fold_in(key, jax.lax.axis_index(axis))
    updated = update_grid(grid, local_key, step, occ_eval_fn, **kwargs)
    occs = jax.lax.pmax(updated.occs, axis_name=axis)
    # Re-binarize after the merge with the SAME threshold rule update_grid
    # used (grid.py:310-313): adaptive min(mean, occ_thre) during warmup or
    # when adaptive_thre, else the fixed occ_thre — so --fixed_occ_thre
    # keeps working under data parallelism.
    occ_thre = kwargs.get("occ_thre", 1e-2)
    adaptive = kwargs.get("adaptive_thre", True)
    warmup = kwargs.get("warmup_steps", 256)
    if adaptive or step < warmup:
        thre = jnp.minimum(jnp.mean(occs), occ_thre)
    else:
        thre = jnp.asarray(occ_thre)
    binary = (occs > thre).reshape(grid.binary.shape)
    return with_binary(grid.replace(occs=occs), binary)
