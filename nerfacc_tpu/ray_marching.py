"""Occupancy-grid accelerated ray marching (static shapes).

Redesign of the reference sampler (``nerfacc/ray_marching.py`` +
``cuda/csrc/ray_marching.cu``). The CUDA version runs a per-ray serial DDA
while-loop, counts samples, syncs to host, allocates exact-size buffers and
re-marches. That count-then-allocate pattern is hostile to XLA (dynamic
shapes + host sync), and a serial per-ray loop does not vectorize.

Static-shape formulation (everything dense, zero scatters, only
bit-table row gathers):

  1. *Generate* a candidate lattice ``t[k]`` per ray with the exact step
     recurrence of the reference (``calc_dt``: ``dt = clamp(t * cone,
     dt_min, dt_max)``, ``ray_marching.cu:9-14``) in closed form — the
     recurrence is piecewise (linear, geometric, linear), so ``t[k]`` is a
     direct vectorized function of ``k``. Shape (n_rays, S).
  2. *Mask* candidates with a bit-packed occupancy lookup (row gather +
     lane select, :mod:`nerfacc_tpu.lookup`) — optionally at a coarse
     stride against the 1-voxel-dilated grid (no false negatives), with an
     exact per-slot re-check in step 4.
  3. *Select slots*: each ray keeps its first ``K`` live candidates. The
     selection indices are computed with a two-level chunked rank-search
     (dense compare+reduce over 128-candidate chunks) — no sort, no
     nonzero, no scatter. Output layout is dense ``(n_rays, K)``: samples
     of one ray are one row, so transmittance scans are plain row cumsums
     and ``ray_indices`` is an iota.
  4. *Re-evaluate* ``t`` at the selected lattice positions in closed form
     (nothing is gathered back), apply the exact occupancy bit at the
     selected midpoints, and optionally cull by ``sigma_fn``/``alpha_fn``
     visibility exactly like the reference (``ray_marching.py:192-220``).

For ``cone_angle == 0`` the emitted sample positions are identical to the
reference's (its DDA advance is lattice-preserving: ``advance_to_next_voxel``
steps in multiples of ``dt_min``, ``ray_marching.cu:59-75``). For
``cone_angle > 0`` the reference's skip also *resets* the step-growth clock
inside empty space; we keep the un-skipped schedule (a documented,
quality-neutral divergence).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
from typing import Callable, NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .grid import OccupancyGrid
from .intersection import ray_aabb_intersect

MAX_DIST = 1e10


class RaySegments(NamedTuple):
    """Dense per-ray samples: row r holds ray r's live samples, K slots.

    When a ray has more live candidates than slots, the marcher *decimates*:
    it keeps every s-th live candidate (s = ceil(count / K)) and widens that
    sample's integration width ``deltas`` to cover its s-group — a coarser
    Riemann sum over the same live interval instead of a front-truncation.
    With enough slots (s == 1), ``deltas == t_ends - t_starts`` exactly and
    the sample set matches the reference's.

    The flat views (``.ray_indices``, reshape of t/masks) satisfy the
    packed-layout contract used everywhere else (sorted ray ids + validity
    mask); the 2D views make scans and accumulation plain row ops.
    """

    t_starts: jnp.ndarray  # (n_rays, K) f32 — lattice interval start
    t_ends: jnp.ndarray  # (n_rays, K) f32 — lattice interval end
    deltas: jnp.ndarray  # (n_rays, K) f32 — integration width (>= te - ts)
    masks: jnp.ndarray  # (n_rays, K) bool

    @property
    def n_rays(self) -> int:
        return self.t_starts.shape[0]

    @property
    def slots_per_ray(self) -> int:
        return self.t_starts.shape[1]

    @property
    def ray_indices(self) -> jnp.ndarray:
        r, k = self.t_starts.shape
        return jnp.broadcast_to(
            jnp.arange(r, dtype=jnp.int32)[:, None], (r, k)
        ).reshape(-1)


def samples_needed_for_range(
    t_min: float,
    t_max: float,
    render_step_size: float,
    cone_angle: float = 0.0,
    dt_max: float = MAX_DIST,
) -> int:
    """Lattice points needed to cover ``[t_min, t_max]`` — the closed-form
    count of the reference's unbounded per-ray marching loop
    (``ray_marching.cu:139-161``: ``t += clamp(t * cone, dt, dt_max)``
    until ``t >= t_max``, with NO sample cap).

    Config-sizing helper: a ``max_samples_per_ray`` below this value
    TRUNCATES every ray's far range — on unbounded scenes the far field
    then cannot be sampled at all, which trains to a catastrophic
    per-view-inconsistent fake (measured: the 360 benchmark collapses to
    5-16 PSNR when starved at S=1024 vs 42.5 infra ceiling covered;
    ``scripts/diag_360.py``). With ``cone_angle == 0`` the count is
    ``(t_max - t_min) / step`` — astronomically large for real unbounded
    far planes, which is *why* cone stepping exists.
    """
    if t_max <= t_min:
        return 0
    if cone_angle <= 0.0:
        return int(math.ceil((t_max - t_min) / render_step_size))
    c, dmin, dmax = cone_angle, render_step_size, dt_max
    # phase A: linear dmin steps until t * c >= dmin
    n_a = math.ceil(max(dmin / c - t_min, 0.0) / dmin)
    t_a = t_min + n_a * dmin
    if t_a >= t_max:
        return int(math.ceil((t_max - t_min) / dmin))
    # phase B: geometric growth by (1 + c) until t * c >= dmax
    t_b_end = min(t_max, dmax / c)
    n_b = math.ceil(math.log(t_b_end / t_a) / math.log1p(c))
    if t_max <= dmax / c:
        return int(n_a + n_b)
    # phase C: linear dmax steps
    t_b = t_a * (1.0 + c) ** n_b
    return int(n_a + n_b + math.ceil((t_max - t_b) / dmax))


class PackedSamples(NamedTuple):
    """Flat fixed-capacity packed samples (reference layout:
    ``(ray_indices, t_starts, t_ends)`` + validity ``masks``)."""

    ray_indices: jnp.ndarray  # (budget,) int32, sorted ascending
    t_starts: jnp.ndarray  # (budget, 1) f32
    t_ends: jnp.ndarray  # (budget, 1) f32
    masks: jnp.ndarray  # (budget,) bool


def _lattice_t(
    t_min: jnp.ndarray,
    k: jnp.ndarray,
    step_size: float,
    cone_angle: float,
    dt_max: float = MAX_DIST,
) -> jnp.ndarray:
    """Closed-form lattice position t(k) for arbitrary (broadcastable) k.

    Implements the reference recurrence ``t += clamp(t * cone_angle,
    step_size, dt_max)`` (``ray_marching.cu:139-161``) without a loop:
    phase A (t < dt_min/cone): linear steps of dt_min;
    phase B: geometric growth by (1 + cone);
    phase C (t >= dt_max/cone): linear steps of dt_max.
    """
    k = k.astype(jnp.float32)
    t_min = t_min.astype(jnp.float32)
    if cone_angle <= 0.0:
        return t_min + k * step_size
    c = cone_angle
    dmin, dmax = step_size, dt_max
    nA = jnp.ceil(jnp.maximum(dmin / c - t_min, 0.0) / dmin)
    tA = t_min + nA * dmin
    log_grow = math.log1p(c)
    ratio = dmax / (c * jnp.maximum(tA, 1e-10))
    nB = jnp.ceil(jnp.maximum(jnp.log(jnp.maximum(ratio, 1.0)), 0.0) / log_grow)
    kA = jnp.minimum(k, nA)
    kB = jnp.clip(k - nA, 0.0, nB)
    kC = jnp.maximum(k - nA - nB, 0.0)
    return (t_min + kA * dmin) * jnp.exp(log_grow * kB) + kC * dmax


def _lattice_k(
    t_min: jnp.ndarray,
    t: jnp.ndarray,
    step_size: float,
    cone_angle: float,
    dt_max: float = MAX_DIST,
) -> jnp.ndarray:
    """Inverse of :func:`_lattice_t`: the (fractional) lattice index k with
    t(k) == t. Used to count in-range candidates in closed form."""
    t_min = t_min.astype(jnp.float32)
    t = t.astype(jnp.float32)
    if cone_angle <= 0.0:
        return (t - t_min) / step_size
    c = cone_angle
    dmin, dmax = step_size, dt_max
    nA = jnp.ceil(jnp.maximum(dmin / c - t_min, 0.0) / dmin)
    tA = t_min + nA * dmin
    log_grow = math.log1p(c)
    ratio = dmax / (c * jnp.maximum(tA, 1e-10))
    nB = jnp.ceil(jnp.maximum(jnp.log(jnp.maximum(ratio, 1.0)), 0.0) / log_grow)
    tB = tA * jnp.exp(log_grow * nB)
    kA = (t - t_min) / dmin
    kB = nA + jnp.log(jnp.maximum(t / jnp.maximum(tA, 1e-10), 1e-30)) / log_grow
    kC = nA + nB + (t - tB) / dmax
    return jnp.where(t <= tA, kA, jnp.where(t <= tB, kB, kC))


@jax.named_scope("slot_select")
def select_slots(
    valid: jnp.ndarray, k_slots: int, decimate: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per row, pick ``k_slots`` live entries: the first K, or — when a row
    has more than K live entries and ``decimate`` — every s-th one
    (s = ceil(count / K)), so the slots always *cover* the live range.

    The stream-compaction primitive, reformulated with static shapes:
    position of the rank-t live candidate = rank search over the row's
    running count. Runs as (a) a row cumsum, (b) a tiny dense chunk-rank
    reduce, (c) one row gather of the target 128-wide chunk, (d) an
    in-chunk dense rank reduce. No sort / nonzero / scatter anywhere.

    Args:
        valid: (R, S) bool.
        k_slots: static number of slots per row (<= S).
        decimate: spread slots over the live range instead of truncating.

    Returns:
        pos: (R, k_slots) int32 in [0, S) — clamped for invalid slots.
        ok: (R, k_slots) bool — slot carries a real sample.
        scale: (R, k_slots) int32 — how many live candidates the slot
            represents (1 unless decimating; multiply integration widths).
    """
    R, S = valid.shape
    c = jnp.cumsum(valid.astype(jnp.int32), axis=1)  # (R, S) inclusive
    count = c[:, -1:]  # (R, 1)
    j = jnp.arange(k_slots, dtype=jnp.int32)[None, :]  # (1, K)
    if decimate:
        stride = (count + k_slots - 1) // k_slots  # ceil; >= 0
        stride = jnp.maximum(stride, 1)
    else:
        stride = jnp.ones_like(count)
    tgt = j * stride + 1  # (R, K) rank targets
    ok = tgt <= count
    # each slot represents its group of `stride` live candidates; the last
    # group may be smaller
    scale = jnp.clip(count - j * stride, 0, stride)

    pad = (-S) % 128
    if pad:
        c_p = jnp.concatenate(
            [c, jnp.broadcast_to(c[:, -1:], (R, pad))], axis=1
        )
    else:
        c_p = c
    nc = c_p.shape[1] // 128
    chunk_rows = c_p.reshape(R * nc, 128)
    chunk_last = c_p.reshape(R, nc, 128)[:, :, -1]  # (R, nc)
    # chunk holding the rank-tgt live entry = #chunks fully before it
    cid = jnp.sum(
        chunk_last[:, :, None] < tgt[:, None, :], axis=1, dtype=jnp.int32
    )
    cid = jnp.minimum(cid, nc - 1)  # (R, K)
    row_ids = jnp.arange(R, dtype=jnp.int32)[:, None] * nc + cid
    rows = chunk_rows[row_ids.reshape(-1)].reshape(R, k_slots, 128)
    pos_in = jnp.sum(rows < tgt[:, :, None], axis=2, dtype=jnp.int32)
    pos = cid * 128 + pos_in
    return jnp.minimum(pos, S - 1), ok, scale


@jax.named_scope("slot_select")
def select_slots_grouped(
    live_per_group: jnp.ndarray,
    group_size: Union[int, jnp.ndarray],
    k_slots: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sample-granular slot selection when the live mask is *group
    structured*: group g contributes its first ``live_per_group[r, g]``
    samples (0 <= that <= group_size). This is exactly the strided-probe
    march's structure (occupancy constant per probe group; the in-t-range
    samples are a prefix), so exact sample-rank selection runs on (R, G)
    arrays — ``group_size``-fold cheaper than materializing (R, S).

    ``group_size`` may be a per-ray (R, 1) int32 array (the adaptive-stride
    march probes each ray's in-range span with ray-specific group sizes).

    Returns (pos, ok, scale) like :func:`select_slots`, with positions in
    sample units (group * group_size + offset).
    """
    R, G = live_per_group.shape
    c = jnp.cumsum(live_per_group, axis=1)  # (R, G) inclusive sample counts
    count = c[:, -1:]
    j = jnp.arange(k_slots, dtype=jnp.int32)[None, :]
    stride = jnp.maximum((count + k_slots - 1) // k_slots, 1)
    tgt = j * stride + 1  # sample-rank targets (R, K)
    ok = tgt <= count
    scale = jnp.clip(count - j * stride, 0, stride)
    # group holding the rank-tgt live sample = #groups fully before it
    gidx = jnp.sum(
        c[:, :, None] < tgt[:, None, :], axis=1, dtype=jnp.int32
    )  # (R, K)
    gidx = jnp.minimum(gidx, G - 1)
    cum_before = jnp.where(
        gidx > 0, gather_rows_dense(c, jnp.maximum(gidx - 1, 0)), 0
    )
    offset = tgt - 1 - cum_before  # rank within the group's live prefix
    pos = gidx * group_size + jnp.clip(offset, 0, group_size - 1)
    return pos, ok, scale


def gather_rows_dense(vals: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``vals[r, idx[r, j]]`` per row via a one-hot reduce (no gather).

    A dense formulation for small (R, K<=128) sources; whether it beats a
    plain ``take_along_axis`` gather on the GPU is not measured.

    Args:
        vals: (R, S) values (S expected modest, e.g. a slot axis).
        idx: (R, K) int32 in [0, S).

    Returns:
        (R, K).
    """
    S = vals.shape[1]
    iota = jnp.arange(S, dtype=jnp.int32)[None, None, :]
    onehot = iota == idx[:, :, None]  # (R, K, S)
    if vals.dtype == jnp.bool_:
        return jnp.any(onehot & vals[:, None, :], axis=2)
    zero = jnp.zeros((), vals.dtype)
    return jnp.sum(jnp.where(onehot, vals[:, None, :], zero), axis=2)


@jax.named_scope("probe")
def probe_live_groups(
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
    grid: OccupancyGrid,
    render_step_size: float,
    cone_angle: float = 0.0,
    max_samples_per_ray: int = 1024,
    coarse_stride: int = 8,
    dt_max: float = MAX_DIST,
    probe_dilation: int = 1,
    probe_groups: Optional[int] = None,
) -> jnp.ndarray:
    """Live-candidate counts per probe group: (n_rays, G) int32.

    One dilated-grid lookup per group at its center candidate; the
    in-t-range candidates of a group are a closed-form prefix (via the
    lattice inverse). ``sum(axis=1)`` gives per-ray live-candidate counts
    — usable for empty-ray compaction before any per-sample work.

    ``probe_dilation`` is the dilation radius (1, 2 or 4) of the probed
    table; stride validity requires ``stride * step / 2 <= radius * voxel``.

    ``probe_groups`` enables the *adaptive-stride* probe layout: instead
    of ``G = S / C`` fixed-stride-C groups (most of which sit beyond
    ``t_max`` for short rays and probe clamped duplicate points), each ray
    gets exactly ``G = probe_groups`` groups with a per-ray stride
    ``s = clip(ceil(k_in / G), 1, C)`` sized to its in-range span — the
    same coverage at a fraction of the lookup volume. ``C`` remains the
    dilation-validity cap; rays with more than ``G * C`` in-range
    candidates have their tail truncated (size G accordingly).
    """
    S, C = max_samples_per_ray, coarse_stride
    # candidates in t-range: t_mid(k) < t_max  <=>  k < k_of(t_max) - 1/2
    k_in = jnp.clip(
        jnp.ceil(
            _lattice_k(t_min, t_max, render_step_size, cone_angle, dt_max)
            - 0.5
        ),
        0,
        S,
    ).astype(jnp.int32)  # (R,)
    G, s = _probe_layout(k_in, S, C, probe_groups)
    g = jnp.arange(G, dtype=jnp.int32)[None, :]
    kc = (g * s).astype(jnp.float32) + (s.astype(jnp.float32) - 1.0) / 2.0 + 0.5
    t_probe = _lattice_t(
        t_min[:, None], kc, render_step_size, cone_angle, dt_max
    )
    # groups straddling t_max: probe inside the live range (the scene box
    # ends there — a probe beyond it would read "empty"); stays within the
    # dilation radius of every live sample while stride * step <= min voxel.
    t_probe = jnp.minimum(t_probe, t_max[:, None] - 0.5 * render_step_size)
    xyz = rays_o[:, None, :] + t_probe[..., None] * rays_d[:, None, :]
    occ = grid.query_occ_fast(xyz, dilated=probe_dilation)  # (R, G)
    in_range_g = jnp.clip(k_in[:, None] - g * s, 0, s)
    return jnp.where(occ, in_range_g, 0)


def _probe_layout(
    k_in: jnp.ndarray, S: int, C: int, probe_groups: Optional[int]
) -> Tuple[int, jnp.ndarray]:
    """(G, per-ray group size (R, 1)) for fixed- or adaptive-stride probes."""
    if probe_groups is None:
        return S // C, jnp.full((k_in.shape[0], 1), C, jnp.int32)
    G = probe_groups
    s = jnp.clip((k_in[:, None] + G - 1) // G, 1, C)
    return G, s.astype(jnp.int32)


def march_rays(
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
    grid: Optional[OccupancyGrid] = None,
    render_step_size: float = 1e-3,
    cone_angle: float = 0.0,
    max_samples_per_ray: int = 1024,
    slots_per_ray: int = 64,
    coarse_stride: int = 1,
    dt_max: float = MAX_DIST,
    live_groups: Optional[jnp.ndarray] = None,
    probe_dilation: int = 1,
    exact_recheck: bool = True,
    probe_groups: Optional[int] = None,
) -> RaySegments:
    """Grid-accelerated marching into a dense (n_rays, K) slot layout.

    ``live_groups`` optionally supplies precomputed
    :func:`probe_live_groups` output (e.g. after empty-ray compaction) so
    the probes are not re-evaluated.

    ``coarse_stride`` > 1 tests occupancy every C-th candidate against the
    1-voxel-dilated grid (recall 1, some extra positives), then re-checks
    the exact grid at the K selected slots — cutting lookup volume ~C-fold.
    Choose C such that ``C * render_step_size <= min voxel extent`` so the
    dilated test cannot miss an occupied voxel.

    With C > 1 the live mask is *group structured* (occupancy constant per
    probe group; the in-t-range samples of a group are a closed-form
    prefix), so exact sample-granular slot selection runs on (R, S/C)
    arrays via :func:`select_slots_grouped` — the sample sets match the
    C=1 path exactly up to dilation positives, which the per-slot exact
    re-check removes.
    """
    n_rays = rays_o.shape[0]
    S, K, C = max_samples_per_ray, slots_per_ray, coarse_stride
    assert K <= S and S % max(C, 1) == 0

    if grid is not None and C > 1:
        live_g = live_groups
        if live_g is None:
            live_g = probe_live_groups(
                rays_o, rays_d, t_min, t_max, grid,
                render_step_size=render_step_size, cone_angle=cone_angle,
                max_samples_per_ray=S, coarse_stride=C, dt_max=dt_max,
                probe_dilation=probe_dilation, probe_groups=probe_groups,
            )
        # reconstruct the per-ray probe layout (deterministic from the
        # t-range — works for live_groups gathered through ray compaction)
        k_in = jnp.clip(
            jnp.ceil(
                _lattice_k(t_min, t_max, render_step_size, cone_angle, dt_max)
                - 0.5
            ),
            0,
            S,
        ).astype(jnp.int32)
        _, group_size = _probe_layout(k_in, S, C, probe_groups)
        pos, ok, scale = select_slots_grouped(live_g, group_size, K)
    else:
        k = jnp.arange(S, dtype=jnp.float32)[None, :]
        t_mid = _lattice_t(
            t_min[:, None], k + 0.5, render_step_size, cone_angle, dt_max
        )
        # in-range rule shared with the grouped fast path: the closed-form
        # lattice inverse, NOT a direct t_mid < t_max compare — the two
        # round differently at the f32 seam and would disagree by +-1
        # sample at the end of each ray's range
        k_in = jnp.clip(
            jnp.ceil(
                _lattice_k(t_min, t_max, render_step_size, cone_angle, dt_max)
                - 0.5
            ),
            0,
            S,
        )
        valid = k < k_in[:, None]
        if grid is not None:
            xyz = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
            valid = valid & grid.query_occ_fast(xyz)
        pos, ok, scale = select_slots(valid, K)  # (R, K)
    with jax.named_scope("slot_select"):
        t_starts = _lattice_t(
            t_min[:, None], pos.astype(jnp.float32), render_step_size,
            cone_angle, dt_max,
        )
        t_ends = _lattice_t(
            t_min[:, None],
            pos.astype(jnp.float32) + 1.0,
            render_step_size,
            cone_angle,
            dt_max,
        )
        # Exact group width in closed form: with cone_angle > 0 the later
        # intervals in a decimation s-group are geometrically larger, so
        # (t_ends - t_starts) * scale would under-cover the group's range.
        # Identical to that expression when cone_angle == 0 or scale == 1.
        deltas = (
            _lattice_t(
                t_min[:, None],
                (pos + scale).astype(jnp.float32),
                render_step_size,
                cone_angle,
                dt_max,
            )
            - t_starts
        )
    return _finish_segments(
        rays_o, rays_d, t_starts, t_ends, deltas, ok, grid,
        exact_recheck=grid is not None and C > 1 and exact_recheck,
    )


@jax.named_scope("recheck")
def _finish_segments(
    rays_o, rays_d, t_starts, t_ends, deltas, masks, grid, exact_recheck
) -> RaySegments:
    """Optional exact per-slot occupancy re-check + RaySegments assembly.

    The re-check removes dilation positives from the strided probe march:
    ~2 ms/step at 786k slots (bit-table row gather + lane select); turning
    it off composites dilation-shell samples (the field reads ~0 density
    there once trained) — measured -6.6 dB, so it stays on by default.
    """
    if exact_recheck:
        mid = (t_starts + t_ends) * 0.5
        xyz = rays_o[:, None, :] + mid[..., None] * rays_d[:, None, :]
        masks = masks & grid.query_occ_fast(xyz)
    return RaySegments(
        t_starts=t_starts, t_ends=t_ends, deltas=deltas, masks=masks
    )


@jax.named_scope("reselect")
def reselect_visible(segs: RaySegments, k2: int) -> RaySegments:
    """Stage-2 re-selection: re-pack each ray's live samples into ``k2``
    slots (the reference's cull-then-render recompaction,
    ``ray_marching.py:216-220`` — there a boolean-mask gather, here a
    static-shape rank selection).

    Decimation-group widths are exact: groups tile the live slots
    contiguously in rank order, so group j's width is the span of the
    masked-delta cumsum from its own start to the next group's start
    (the total for the last live group) — exact even when the source
    deltas are themselves widened.
    """
    pos2, ok2, _ = select_slots(segs.masks, k2)
    d_live = jnp.where(segs.masks, segs.deltas, 0.0)
    cd = jnp.cumsum(d_live, axis=1)  # inclusive
    start_excl = gather_rows_dense(cd, pos2) - gather_rows_dense(d_live, pos2)
    ok_next = jnp.concatenate(
        [ok2[:, 1:], jnp.zeros_like(ok2[:, :1])], axis=1
    )
    next_start = jnp.concatenate([start_excl[:, 1:], cd[:, -1:]], axis=1)
    widths = jnp.where(ok_next, next_start, cd[:, -1:]) - start_excl
    return RaySegments(
        t_starts=gather_rows_dense(segs.t_starts, pos2),
        t_ends=gather_rows_dense(segs.t_ends, pos2),
        deltas=jnp.where(ok2, widths, 0.0),
        masks=ok2,
    )


_starvation_warned = set()


def _warn_if_lattice_starved(
    scene_aabb,
    near_plane,
    far_plane,
    render_step_size,
    cone_angle,
    dt_max,
    max_samples_per_ray,
):
    """Warn (once per config) when the static candidate lattice cannot
    cover >= 90% of the statically-knowable t-range.

    The reference's CUDA marcher has no per-ray sample cap
    (``ray_marching.cu:139-161`` marches until ``t_max``); our static
    lattice is capped at ``max_samples_per_ray``, and an undersized cap
    silently truncates every ray's far range — measured to collapse
    unbounded training to 5-16 PSNR (``scripts/diag_360.py``,
    docs/benchmarks.md "360 collapse"). This check is trace-time-only
    and uses whatever static range information exists: [near, far] when
    both are Python scalars, else the aabb diagonal as the worst-case
    extent for a concrete ``scene_aabb``. Dynamic (traced) ranges are
    not checkable and are skipped.
    """
    t_lo = float(near_plane) if near_plane is not None else 0.0
    coverage = 0.9
    if far_plane is not None:
        t_hi = float(far_plane)
    elif scene_aabb is not None:
        try:
            aabb = np.asarray(scene_aabb, dtype=np.float64)
        except Exception:
            return  # traced aabb: range unknowable at trace time
        if aabb.size != 6 or not np.isfinite(aabb).all():
            return
        diag = float(np.linalg.norm(aabb[3:] - aabb[:3]))
        t_hi = t_lo + diag
        # the diagonal is the WORST-case span — typical rays cross far
        # less of a bounded box, so only warn when the lattice covers
        # under half of it (an explicit [near, far] keeps the 90% rule:
        # there every ray really owns the full range)
        coverage = 0.5
    else:
        return  # [0, 1e10] default range: nothing meaningful to check
    if not (t_hi > t_lo) or t_hi >= MAX_DIST:
        return
    key = (
        round(t_lo, 9), round(t_hi, 9), float(render_step_size),
        float(cone_angle), float(dt_max), int(max_samples_per_ray),
    )
    if key in _starvation_warned:
        return
    needed = samples_needed_for_range(
        t_lo, t_lo + coverage * (t_hi - t_lo), render_step_size,
        cone_angle=cone_angle, dt_max=dt_max,
    )
    if max_samples_per_ray < needed:
        _starvation_warned.add(key)
        warnings.warn(
            f"max_samples_per_ray={max_samples_per_ray} covers less than "
            f"90% of the t-range [{t_lo:g}, {t_hi:g}] at "
            f"render_step_size={render_step_size:g}, "
            f"cone_angle={cone_angle:g} (full coverage needs "
            f"{samples_needed_for_range(t_lo, t_hi, render_step_size, cone_angle=cone_angle, dt_max=dt_max)} "
            "lattice points). The far range is truncated on every ray; "
            "unbounded training collapses when starved (measured 5-16 "
            "PSNR). Raise max_samples_per_ray, set cone_angle > 0, or "
            "shrink [near_plane, far_plane]. "
            "(samples_needed_for_range() sizes this in closed form.)",
            RuntimeWarning,
            stacklevel=3,
        )


def _resolve_t_range(
    rays_o,
    rays_d,
    t_min,
    t_max,
    scene_aabb,
    near_plane,
    far_plane,
    stratified,
    key,
    render_step_size,
    *,
    cone_angle=None,
    dt_max=MAX_DIST,
    max_samples_per_ray=None,
):
    """Reference t-range priority: explicit > aabb intersect > [0, 1e10],
    then near/far clamps and stratified jitter (``ray_marching.py:138-158``).

    When ``cone_angle``/``max_samples_per_ray`` are provided, also runs
    the trace-time lattice-starvation guard (warn-once)."""
    if max_samples_per_ray is not None and cone_angle is not None:
        _warn_if_lattice_starved(
            scene_aabb, near_plane, far_plane, render_step_size,
            cone_angle, dt_max, max_samples_per_ray,
        )
    n_rays = rays_o.shape[0]
    if t_min is None or t_max is None:
        if scene_aabb is not None:
            t_min, t_max = ray_aabb_intersect(rays_o, rays_d, scene_aabb)
        else:
            t_min = jnp.zeros(n_rays, dtype=rays_o.dtype)
            t_max = jnp.full((n_rays,), MAX_DIST, dtype=rays_o.dtype)
    if near_plane is not None:
        t_min = jnp.maximum(t_min, near_plane)
    if far_plane is not None:
        t_max = jnp.minimum(t_max, far_plane)
    if stratified:
        t_min = t_min + jax.random.uniform(key, t_min.shape) * render_step_size
    return t_min, t_max


def ray_marching(
    # rays
    rays_o: jnp.ndarray,
    rays_d: jnp.ndarray,
    t_min: Optional[jnp.ndarray] = None,
    t_max: Optional[jnp.ndarray] = None,
    # bounding box of the scene
    scene_aabb: Optional[jnp.ndarray] = None,
    # binarized grid for skipping empty space
    grid: Optional[OccupancyGrid] = None,
    # sigma/alpha function for skipping invisible space
    sigma_fn: Optional[Callable] = None,
    alpha_fn: Optional[Callable] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
    # rendering options
    near_plane: Optional[float] = None,
    far_plane: Optional[float] = None,
    render_step_size: float = 1e-3,
    stratified: bool = False,
    cone_angle: float = 0.0,
    # static-shape controls
    key: Optional[jax.Array] = None,
    max_samples_per_ray: int = 512,
    samples_budget: Optional[int] = None,
    visible_samples_budget: Optional[int] = None,
    coarse_stride: int = 1,
    dt_max: float = MAX_DIST,
    probe_dilation: int = 1,
    probe_groups: Optional[int] = None,
    exact_recheck: bool = True,
) -> PackedSamples:
    """March rays with empty/occluded-space skipping (reference
    ``ray_marching.py:13-222``), flat packed output.

    t-range resolution follows the reference priority: explicit
    ``t_min``/``t_max`` > ``scene_aabb`` intersection > ``[0, 1e10]``, then
    near/far clamping; stratified jitter adds ``U[0,1) * step`` to t_min.

    Static-shape args:
        key: PRNG key, required when ``stratified=True`` (replaces the
            reference's global torch RNG).
        max_samples_per_ray: static candidate-lattice length S.
        samples_budget: static total sample capacity; each ray gets
            ``K = min(S, ceil(budget / n_rays))`` slots (default S).
        visible_samples_budget: if set together with ``sigma_fn`` /
            ``alpha_fn``, re-select visible samples into the smaller
            per-ray capacity — the reference's cull-then-render trick
            with static shapes.
        coarse_stride: see :func:`march_rays`.
        probe_dilation / probe_groups / exact_recheck: the fast-path
            probe knobs of :func:`march_rays` (dilated-table radius,
            adaptive per-ray probe strides, exact per-slot re-check) —
            the configuration ``utils.render_rays`` uses for its
            benchmark numbers, exposed here so parity-API users get the
            same throughput.

    Returns:
        :class:`PackedSamples` ``(ray_indices, t_starts, t_ends, masks)``
        with ``budget = n_rays * K`` entries, ray-major (sorted).
    """
    n_rays = rays_o.shape[0]
    if alpha_fn is not None and sigma_fn is not None:
        raise ValueError("Only one of `alpha_fn` and `sigma_fn` should be provided.")
    if stratified and key is None:
        raise ValueError("stratified=True requires a PRNG `key`.")

    t_min, t_max = _resolve_t_range(
        rays_o, rays_d, t_min, t_max, scene_aabb, near_plane, far_plane,
        stratified, key, render_step_size,
        cone_angle=cone_angle, dt_max=dt_max,
        max_samples_per_ray=max_samples_per_ray,
    )

    S = max_samples_per_ray
    if samples_budget is None:
        K = S
    else:
        K = min(S, max(1, -(-samples_budget // n_rays)))
    segs = march_rays(
        rays_o, rays_d, t_min, t_max, grid,
        render_step_size=render_step_size,
        cone_angle=cone_angle,
        max_samples_per_ray=S,
        slots_per_ray=K,
        coarse_stride=coarse_stride if grid is not None else 1,
        dt_max=dt_max,
        probe_dilation=probe_dilation,
        probe_groups=probe_groups,
        exact_recheck=exact_recheck,
    )

    # visibility culling (reference ray_marching.py:192-220)
    if sigma_fn is not None or alpha_fn is not None:
        from .vol_rendering import render_visibility_dense

        flat = _flatten_segments(segs)
        if sigma_fn is not None:
            sigmas = sigma_fn(flat.t_starts, flat.t_ends, flat.ray_indices)
            alphas = 1.0 - jnp.exp(
                -sigmas.reshape(n_rays, K) * segs.deltas
            )
        else:
            alphas = alpha_fn(
                flat.t_starts, flat.t_ends, flat.ray_indices
            ).reshape(n_rays, K)
        vis = render_visibility_dense(
            alphas, segs.masks, early_stop_eps=early_stop_eps,
            alpha_thre=alpha_thre,
        )
        segs = segs._replace(masks=segs.masks & vis)
        if visible_samples_budget is not None:
            K2 = min(K, max(1, -(-visible_samples_budget // n_rays)))
            segs = reselect_visible(segs, K2)

    return _flatten_segments(segs)


def _flatten_segments(segs: RaySegments) -> PackedSamples:
    """Dense (R, K) -> flat packed (R*K,) with sorted ray indices.

    The flat ``t_ends`` is ``t_starts + deltas`` so downstream
    ``sigma * (t_ends - t_starts)`` integrates the decimation-scaled width
    (identical to the lattice interval when no decimation happened).
    """
    r, k = segs.t_starts.shape
    return PackedSamples(
        ray_indices=segs.ray_indices,
        t_starts=segs.t_starts.reshape(-1, 1),
        t_ends=(segs.t_starts + segs.deltas).reshape(-1, 1),
        masks=segs.masks.reshape(-1),
    )
