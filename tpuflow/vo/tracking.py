"""Flow-based feature tracking (the VO front-end).

Connects the dense-flow engine to the pose-graph/BA back-end: features
are seeded on a grid, scored with the Shi-Tomasi minimum eigenvalue of
the same 5x5 structure tensor the LK solver builds (reference analog:
the |det| texture gate, python/lucas_kanade_core.py:131, strengthened to
min-eig), and advanced each frame by bilinear sampling of the dense flow
field. Everything is static-shape (fixed feature count + validity mask)
so tracking steps jit and scan.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuflow.core import ops
from tpuflow.kernels import jnp_ref


class Tracks(NamedTuple):
    """A fixed-capacity track table."""

    xy: jax.Array       # (N, 2) float32 current positions (x, y)
    start_xy: jax.Array  # (N, 2) positions at spawn time
    age: jax.Array      # (N,) int32 frames tracked
    alive: jax.Array    # (N,) bool validity


def shi_tomasi_response(frame: jax.Array, window: int = 5) -> jax.Array:
    """Min-eigenvalue corner response of the 5x5 structure tensor."""
    ix, iy, _ = jnp_ref.compute_gradients(frame, frame)
    half = window // 2
    s_xx = ops.uniform_window_sum_valid(ix * ix, window)
    s_yy = ops.uniform_window_sum_valid(iy * iy, window)
    s_xy = ops.uniform_window_sum_valid(ix * iy, window)
    tr = s_xx + s_yy
    disc = jnp.sqrt(jnp.square(s_xx - s_yy) + 4.0 * jnp.square(s_xy))
    min_eig = 0.5 * (tr - disc)
    return jnp.pad(min_eig, ((half, half), (half, half)))


def seed_grid(
    frame: jax.Array,
    grid_step: int = 16,
    min_response: float = 1.0,
    margin: int = 0,
) -> Tracks:
    """Seed one feature per grid cell at the cell's best corner.

    ``margin``: exclude a border stripe from seeding (the dense-flow
    field is unreliable within ~(max_disp + window) of the border — see
    device_loop.FrontEnd.margin). Cells straddling the stripe pick their
    best corner outside it; cells fully inside seed nothing. Without
    this, border seeds die on their first ``advance`` and are re-minted
    with fresh landmark ids every keyframe — pure id churn.
    """
    h, w = frame.shape
    resp = shi_tomasi_response(frame)
    if margin > 0:
        y = jnp.arange(h)[:, None]
        x = jnp.arange(w)[None, :]
        inside = (
            (y >= margin) & (y < h - margin)
            & (x >= margin) & (x < w - margin)
        )
        resp = jnp.where(inside, resp, -jnp.inf)
    gy = h // grid_step
    gx = w // grid_step
    s = grid_step
    # Per-cell argmax WITHOUT the (gy, s, gx, s) -> (gy, gx, s, s)
    # transpose (a full-plane relayout): reduce the cell max, then
    # recover argmax's exact first-occurrence tie-breaking as the
    # minimum within-cell row-major index among the maxima — three
    # layout-friendly reductions, zero relayouts.
    # Bit-identical to the argmax form (including all--inf margin cells,
    # where both pick local index 0).
    r4 = resp[: gy * s, : gx * s].reshape(gy, s, gx, s)
    cell_max = r4.max(axis=(1, 3))
    ly = jax.lax.broadcasted_iota(jnp.int32, (gy, s, gx, s), 1)
    lx = jax.lax.broadcasted_iota(jnp.int32, (gy, s, gx, s), 3)
    is_max = r4 == cell_max[:, None, :, None]
    best = (
        jnp.where(is_max, ly * s + lx, s * s)
        .min(axis=(1, 3))
        .reshape(gy * gx)
    )
    best_resp = cell_max.reshape(gy * gx)
    cy = best // s
    cx = best % s
    base_y = (jnp.arange(gy * gx) // gx) * grid_step
    base_x = (jnp.arange(gy * gx) % gx) * grid_step
    xy = jnp.stack(
        [(base_x + cx).astype(jnp.float32), (base_y + cy).astype(jnp.float32)],
        axis=1,
    )
    alive = best_resp > min_response
    return Tracks(
        xy=xy,
        start_xy=xy,
        age=jnp.zeros(gy * gx, jnp.int32),
        alive=alive,
    )


def sample_flow(
    flow_u: jax.Array, flow_v: jax.Array, xy: jax.Array
) -> jax.Array:
    """Bilinear flow sample at (N, 2) positions -> (N, 2) (du, dv).

    Value-identical to ``ops.map_coordinates_bilinear`` per plane (same
    corner clamping, same lerp order, same hard-OOB zero), but issued
    as ONE flattened 1-D gather per plane instead of four 2-D advanced-
    indexing gathers each (the ``advance`` stage of
    ``tpuflow.eval.profile_vo`` times it)."""
    h, w = flow_u.shape
    x, y = xy[:, 0], xy[:, 1]
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f).astype(flow_u.dtype)[:, None]
    fy = (y - y0f).astype(flow_u.dtype)[:, None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)
    cx0 = jnp.clip(x0, 0, w - 1)
    cx1 = jnp.clip(x0 + 1, 0, w - 1)
    cy0 = jnp.clip(y0, 0, h - 1)
    cy1 = jnp.clip(y0 + 1, 0, h - 1)
    idx = jnp.concatenate(
        [cy0 * w + cx0, cy0 * w + cx1, cy1 * w + cx0, cy1 * w + cx1]
    )
    n = xy.shape[0]
    gu = jnp.take(flow_u.reshape(-1), idx).reshape(4, n)
    gv = jnp.take(flow_v.reshape(-1), idx).reshape(4, n)
    g = jnp.stack([gu, gv], axis=2)  # (4, N, 2)
    top = g[0] * (1.0 - fx) + g[1] * fx
    bot = g[2] * (1.0 - fx) + g[3] * fx
    val = top * (1.0 - fy) + bot * fy
    inside = (y >= 0) & (y <= h - 1) & (x >= 0) & (x <= w - 1)
    return jnp.where(inside[:, None], val, 0.0)


@functools.partial(jax.jit, static_argnames=("margin",))
def advance(
    tracks: Tracks,
    flow_u: jax.Array,
    flow_v: jax.Array,
    margin: int = 3,
) -> Tracks:
    """Move tracks by the dense flow; kill tracks that leave the frame."""
    h, w = flow_u.shape
    d = sample_flow(flow_u, flow_v, tracks.xy)
    xy = tracks.xy + d
    inside = (
        (xy[:, 0] >= margin)
        & (xy[:, 0] <= w - 1 - margin)
        & (xy[:, 1] >= margin)
        & (xy[:, 1] <= h - 1 - margin)
    )
    alive = tracks.alive & inside
    return Tracks(
        xy=jnp.where(alive[:, None], xy, tracks.xy),
        start_xy=tracks.start_xy,
        age=jnp.where(alive, tracks.age + 1, tracks.age),
        alive=alive,
    )


@functools.partial(jax.jit, static_argnames=("threshold",))
def forward_backward_check(
    tracks: Tracks,
    prev_xy: jax.Array,
    flow_bwd_u: jax.Array,
    flow_bwd_v: jax.Array,
    threshold: float = 1.0,
) -> Tracks:
    """Kill tracks that fail the forward-backward consistency test.

    ``tracks`` has already been advanced by the forward flow from
    ``prev_xy``; the backward flow (curr -> prev) sampled at the new
    positions should return each feature to where it started. Round-trip
    error beyond ``threshold`` px marks occlusion or a bad flow estimate
    (standard KLT-style validation — no reference counterpart, the
    reference stops at dense flow).
    """
    back = sample_flow(flow_bwd_u, flow_bwd_v, tracks.xy)
    err = jnp.linalg.norm(tracks.xy + back - prev_xy, axis=1)
    alive = tracks.alive & (err <= threshold)
    return tracks._replace(alive=alive)
