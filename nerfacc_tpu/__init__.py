"""nerfacc_tpu: a NeRF acceleration toolbox in JAX.

A from-scratch re-design of the capabilities of the nerfacc toolbox
(reference ``nerfacc/__init__.py:35-59``) for XLA: occupancy-grid
accelerated ray marching and differentiable volumetric rendering over
packed per-ray samples, built on static-shape fixed-capacity buffers,
segmented scans, and jax transforms. Rays shard across chips/hosts with
``jax.sharding``; see :mod:`nerfacc_tpu.parallel`.
"""

import warnings

from .cdf import ray_resampling, ResampledRays
from .contraction import ContractionType, contract, contract_inv
from .grid import (
    Grid,
    OccupancyGrid,
    create_grid,
    dilate_binary,
    every_n_step,
    query_grid,
    update_grid,
    with_binary,
)
from .intersection import ray_aabb_intersect
from .losses import distortion as loss_distortion
from .losses import distortion_dense as loss_distortion_dense
from .sampling import proposal_sampling_with_filter, sample_along_rays
from .cdf import ray_resampling_dense
from .pack import pack_data, pack_info, unpack_data, unpack_info, unpack_info_to_mask
from .ray_marching import (
    PackedSamples,
    RaySegments,
    gather_rows_dense,
    march_rays,
    probe_live_groups,
    ray_marching,
    samples_needed_for_range,
    select_slots,
    select_slots_grouped,
)
from .version import __version__
from .vol_rendering import (
    accumulate_along_rays,
    accumulate_along_rays_dense,
    render_transmittance_from_alpha,
    render_transmittance_from_density,
    render_visibility,
    render_visibility_dense,
    render_weight_from_alpha,
    render_weight_from_alpha_dense,
    render_weight_from_density,
    render_weight_from_density_dense,
    rendering,
    rendering_dense,
)


# Deprecated alias kept for API parity with the reference (__init__.py:26-32).
def unpack_to_ray_indices(*args, **kwargs):
    warnings.warn(
        "`unpack_to_ray_indices` will be deprecated. Please use `unpack_info` instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    return unpack_info(*args, **kwargs)


__all__ = [
    "__version__",
    "Grid",
    "OccupancyGrid",
    "create_grid",
    "update_grid",
    "every_n_step",
    "query_grid",
    "with_binary",
    "dilate_binary",
    "RaySegments",
    "march_rays",
    "select_slots",
    "select_slots_grouped",
    "probe_live_groups",
    "samples_needed_for_range",
    "gather_rows_dense",
    "accumulate_along_rays_dense",
    "render_visibility_dense",
    "render_weight_from_alpha_dense",
    "render_weight_from_density_dense",
    "rendering_dense",
    "ContractionType",
    "contract",
    "contract_inv",
    "ray_aabb_intersect",
    "ray_marching",
    "PackedSamples",
    "accumulate_along_rays",
    "render_visibility",
    "render_weight_from_alpha",
    "render_weight_from_density",
    "rendering",
    "pack_data",
    "unpack_data",
    "unpack_info",
    "unpack_info_to_mask",
    "pack_info",
    "ray_resampling",
    "ResampledRays",
    "loss_distortion",
    "loss_distortion_dense",
    "sample_along_rays",
    "proposal_sampling_with_filter",
    "ray_resampling_dense",
    "unpack_to_ray_indices",
    "render_transmittance_from_density",
    "render_transmittance_from_alpha",
]
