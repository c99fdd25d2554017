"""Multi-host (multi-process) scale-out helpers.

The reference is single-process (SURVEY §2.5); this is new design for a
cluster of GPU hosts: one Python process per host, each owning its local
GPUs, a single SPMD program over the global device mesh. Rays stay
host-local end to end (the render path is communication-free under ray
sharding), so the network between hosts only carries the gradient/metric
reductions — the host axis of :func:`psum_grads` — and the
occupancy-grid ``pmax`` merge. Within a host the GPUs reach each other
over NVLink, all to all.

The same code paths are testable without hardware: two CPU processes with
4 virtual devices each form a 2-host x 4-chip mesh over gloo collectives
(see ``tests/test_multihost.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the JAX distributed runtime (multi-host).

    Under a cluster manager JAX can detect (e.g. SLURM), call with no
    arguments — the runtime reads the coordinator and process topology
    from the environment. Everywhere else (a single machine, CPU-process
    simulations), pass ``coordinator_address='host:port'``,
    ``num_processes`` and ``process_id`` explicitly.

    Returns True when a multi-process runtime was initialized, False for
    the single-process no-op (already-initialized runtimes included).

    Must run before any JAX call that initializes the XLA backend
    (``jax.devices``, any computation) — same contract as
    ``jax.distributed.initialize`` itself.
    """
    if _already_initialized():
        return jax.process_count() > 1
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except (ValueError, RuntimeError):
            return False  # single-process environment
        return jax.process_count() > 1
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def _already_initialized() -> bool:
    """Whether the distributed runtime is already up (without touching
    the XLA backend — jax.process_count() would initialize it)."""
    try:
        return bool(jax.distributed.is_initialized())
    except AttributeError:  # pragma: no cover - older jax
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None


def make_host_mesh(
    host_axis: str = "host", chip_axis: str = "chip"
) -> Mesh:
    """2-D ``(hosts, chips-per-host)`` mesh over all global devices.

    Device order groups each process's local devices along the chip
    axis, so ``chip`` collectives stay on the host's NVLink and only the
    ``host`` axis crosses the network. Shard ray batches over *both* axes
    (``P((host_axis, chip_axis))``); reduce gradients over both — XLA
    lowers the reduction hierarchically.

    With one process this degenerates to ``(1, n_chips)`` and is
    interchangeable with :func:`make_mesh`.
    """
    devices = sorted(
        jax.devices(), key=lambda d: (d.process_index, d.id)
    )
    n_proc = jax.process_count()
    per_host = len(devices) // n_proc
    grid = np.asarray(devices).reshape(n_proc, per_host)
    return Mesh(grid, (host_axis, chip_axis))


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """All mesh axis names, for sharding a ray batch over every device."""
    return tuple(mesh.axis_names)


def shard_host_batch(tree, mesh: Mesh):
    """Build globally-sharded arrays from *per-process local* batches.

    Each process passes its local shard (e.g. the rays its own data
    loader produced); the result is a global array sharded over all mesh
    axes on the leading dimension. This is the multi-host analogue of
    :func:`nerfacc_tpu.parallel.shard_batch` (which assumes the full
    batch is addressable in one process).
    """
    spec = P(batch_axes(mesh))
    sharding = NamedSharding(mesh, spec)
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)
        ),
        tree,
    )


def psum_hierarchical(tree, mesh: Mesh):
    """All-reduce over every mesh axis (chip axis within a host, host
    axis across the network; XLA decomposes the reduction
    hierarchically). Call inside ``shard_map`` over ``mesh``."""
    return jax.lax.psum(tree, axis_name=batch_axes(mesh))
