"""On-device VO front-end: the whole per-frame tracking step — dense
flow, track advance, forward-backward culling, loss detection, and
fixed-slot keyframe reseeding — as ONE jitted device program.

The host-paced design this replaces synced device->host every frame
(alive-count readback) and pulled full track tables to host at every
keyframe, so the host, not the flow, set the frame rate. Here the
step never leaves the device: observations come back as device arrays
the caller appends to a list (no sync), loss events land in a
fixed-slot device buffer, and new landmark ids are assigned by an on-device counter + cumsum — the
analog of the reference RTL's never-leave-the-FPGA streaming pipeline
(rtl/common/frame_buffer_simple.sv:60-94), extended to the tracking
layer the reference lacks.

Design rules:
- Static shapes everywhere: the track table is fixed-capacity, reseeding
  writes in place via masks, the loss log is a fixed ring write.
- ``step`` is a pure ``(state, frame) -> (state, obs)`` function, so
  ``jax.lax.scan`` batches whole frame chunks into a single dispatch
  (``scan_steps``) — the serving path for long sequences.
- The previous frame is carried as its Gaussian PYRAMID (untiled mode):
  each frame's pyramid is built once and reused as both the current
  pair's "curr" and the next pair's "prev" (and by the backward
  fb-check flow), bit-identical to per-pair recomputation because a
  frame's pyramid does not depend on the pair it appears in
  (tpuflow.flow.lucas_kanade_pyramidal_step contract).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from tpuflow.core.config import PyramidConfig
from tpuflow.vo import tracking

# Fixed capacity of the on-device tracking-loss event log. Loss events
# (total occlusion transitions) are rare — one per contiguous outage —
# so 64 covers any realistic session; beyond it, events are counted but
# not logged (loss_count keeps the true total).
LOSS_LOG_CAP = 64


class FrontEndState(NamedTuple):
    """Device-resident tracking state (a scan carry)."""

    carry: Any            # prev-frame flow carry: pyramid tuple / (frame,)
    xy: jax.Array         # (N, 2) f32 current track positions
    start_xy: jax.Array   # (N, 2) f32 spawn positions
    age: jax.Array        # (N,) i32
    alive: jax.Array      # (N,) bool
    track_lm: jax.Array   # (N,) i32 landmark id per slot
    n_landmarks: jax.Array  # () i32 on-device landmark id counter
    frame_index: jax.Array  # () i32
    max_alive: jax.Array    # () i32 session peak alive count
    tracking_lost: jax.Array  # () bool
    loss_frames: jax.Array  # (LOSS_LOG_CAP,) i32, -1-filled event log
    loss_count: jax.Array   # () i32


class ObsRecord(NamedTuple):
    """Per-keyframe observation snapshot (device arrays; materialize
    lazily — appending these to a host list costs no sync)."""

    xy: jax.Array          # (N, 2) f32
    lm: jax.Array          # (N,) i32
    alive: jax.Array       # (N,) bool
    n_landmarks: jax.Array  # () i32 counter AFTER this keyframe's reseed


class FrontEnd:
    """Factory for the jitted init/step/scan functions of one session.

    ``mesh``: optional ("batch", "ty", "tx") mesh — the front-end dense
    flow runs spatially tiled with halo exchange inside the same step
    program (tpuflow.sharding.tiled_pyramidal).
    """

    def __init__(
        self,
        grid_step: int = 16,
        keyframe_stride: int = 1,
        fb_check_threshold: float | None = None,
        backend: str = "jnp",
        mesh=None,
        config: PyramidConfig | None = None,
    ) -> None:
        self.grid_step = int(grid_step)
        self.keyframe_stride = int(keyframe_stride)
        self.fb_check_threshold = (
            None if fb_check_threshold is None else float(fb_check_threshold)
        )
        self.backend = backend
        self.mesh = mesh
        # Parity with OdometrySession's historical flow call
        # lucas_kanade_pyramidal(prev, curr, backend=...): default
        # 3-level / 5x5 / 3-iteration config.
        self.config = config or PyramidConfig(
            levels=3, window_size=5, iterations=3
        )
        # Track-culling border stripe width: the dense-flow field is
        # unreliable within ~(max_disp + window) of the border (warp OOB
        # fill + window support + the fast path's clamp all meet there —
        # the same stripe the adaptive band selector masks,
        # flow/pyramidal._select_band_index). See ``margin_for``.
        self.stripe = self.config.max_disp + self.config.window_size
        self.init = jax.jit(self._init)
        self.step = jax.jit(self._step)
        self.scan_steps = jax.jit(self._scan_steps)
        self.carry_of_frame = jax.jit(self._carry_of_frame)

    def margin_for(self, h: int, w: int, for_cull: bool = True) -> int:
        """Seed/cull border margin for a given frame shape (static).

        Tracks seeded in or advanced into the border stripe sample
        garbage flow: measured on the 320x240 VO trajectory suite
        (fast path), a 3 px margin lets the band-config choice swing
        strafe_x rpe_rot 0.11 -> 4.8 deg (the +-3 and +-8 clamps shape
        the stripe's garbage differently) while the full 13 px stripe
        margin makes the bands agree (0.09 vs 0.21 deg), improves mean
        reprojection 0.341 -> 0.233 px, and cuts arc_yaw/dolly_z ATE
        32-48%. But the stripe is only excluded when it costs little
        field of view — on small frames the border tracks carry most of
        the scale/parallax leverage: the 160x120 visual-inertial
        metric-span recovery degrades 0.99 -> 0.77 with the full stripe
        excluded (either at seed or at cull, measured independently).
        Rule: full stripe margin when min(h, w) >= 16x the stripe
        (stripe <= ~6% of the frame dimension), else the legacy values
        (cull margin 3, seed margin 0 — even a 3 px seed exclusion
        measurably degrades the tiny-frame VI span, 0.99 -> 0.77).
        """
        if min(h, w) >= 16 * self.stripe:
            return self.stripe
        return 3 if for_cull else 0

    # -- flow plumbing ------------------------------------------------------

    def _carry_of_frame(self, frame: jax.Array):
        if self.mesh is not None:
            # Tiled flow consumes raw frames (it builds replicated-coarse
            # + sharded-fine pyramids internally).
            return (frame,)
        from tpuflow.kernels import jnp_ref

        cfg = self.config
        return tuple(
            jnp_ref.build_gaussian_pyramid(frame, cfg.levels, cfg.scale_factor)
        )

    def _flow(self, carry_prev, carry_curr):
        cfg = self.config
        if self.mesh is not None:
            from tpuflow.sharding.tiled_pyramidal import (
                tiled_lucas_kanade_pyramidal,
            )

            return tuple(
                x[0] for x in tiled_lucas_kanade_pyramidal(
                    carry_prev[0][None], carry_curr[0][None], self.mesh,
                    config=cfg, backend=self.backend,
                )
            )
        from tpuflow.flow.pyramidal import lucas_kanade_pyramidal_from_pyramids

        return lucas_kanade_pyramidal_from_pyramids(
            carry_prev, carry_curr, cfg, backend=self.backend
        )

    # -- lifecycle ----------------------------------------------------------

    def _init(self, frame: jax.Array) -> tuple[FrontEndState, ObsRecord]:
        """Seed on the first frame; the returned ObsRecord is keyframe 0.

        Every slot gets a landmark id (dead seeds included — their ids
        are simply never validly observed), matching the session's
        historical ``start()`` convention.
        """
        frame = jnp.asarray(frame, jnp.float32)
        t = tracking.seed_grid(
            frame, grid_step=self.grid_step,
            margin=self.margin_for(*frame.shape, for_cull=False),
        )
        n = t.xy.shape[0]
        lm = jnp.arange(n, dtype=jnp.int32)
        n_lm = jnp.asarray(n, jnp.int32)
        state = FrontEndState(
            carry=self._carry_of_frame(frame),
            xy=t.xy,
            start_xy=t.start_xy,
            age=t.age,
            alive=t.alive,
            track_lm=lm,
            n_landmarks=n_lm,
            frame_index=jnp.asarray(0, jnp.int32),
            max_alive=jnp.asarray(0, jnp.int32),
            tracking_lost=jnp.asarray(False),
            loss_frames=jnp.full((LOSS_LOG_CAP,), -1, jnp.int32),
            loss_count=jnp.asarray(0, jnp.int32),
        )
        return state, ObsRecord(xy=t.xy, lm=lm, alive=t.alive, n_landmarks=n_lm)

    def _step(
        self, state: FrontEndState, frame: jax.Array
    ) -> tuple[FrontEndState, ObsRecord]:
        """One tracking step, entirely on device.

        The ObsRecord is returned EVERY step (fixed output structure so
        the function scans); only keyframe steps' records are meaningful
        — the caller keeps those (frame_index % keyframe_stride == 0,
        host-predictable, no readback needed).
        """
        frame = jnp.asarray(frame, jnp.float32)
        carry_curr = self._carry_of_frame(frame)
        u, v = self._flow(state.carry, carry_curr)
        prev_xy = state.xy
        t = tracking.advance(
            tracking.Tracks(state.xy, state.start_xy, state.age, state.alive),
            u, v, margin=self.margin_for(*frame.shape),
        )
        if self.fb_check_threshold is not None:
            ub, vb = self._flow(carry_curr, state.carry)
            t = tracking.forward_backward_check(
                t, prev_xy, ub, vb, threshold=self.fb_check_threshold
            )

        fi = state.frame_index + 1

        # Loss detection relative to the session's PEAK alive count
        # (sparse-texture scenes must not read as permanently lost).
        # Integer form of alive_now < 0.25 * max_alive.
        alive_now = jnp.sum(t.alive).astype(jnp.int32)
        max_alive = jnp.maximum(state.max_alive, alive_now)
        lost = (max_alive > 0) & (alive_now * 4 < max_alive)
        newly_lost = lost & jnp.logical_not(state.tracking_lost)
        write = newly_lost & (state.loss_count < LOSS_LOG_CAP)
        slot = jnp.minimum(state.loss_count, LOSS_LOG_CAP - 1)
        loss_frames = state.loss_frames.at[slot].set(
            jnp.where(write, fi, state.loss_frames[slot])
        )
        loss_count = state.loss_count + newly_lost.astype(jnp.int32)

        # Keyframe: refill dead slots with fresh corners and NEW landmark
        # ids from the on-device counter (ids ascend in slot order,
        # matching the host reseed this replaces).
        #
        # Gated on a dead slot actually existing: reseeding with zero
        # dead slots is an exact no-op (``good = fresh.alive & ~alive``
        # is all-false — nothing changes, no ids are minted), but it
        # still pays the full-frame Shi-Tomasi response (the
        # ``seed_grid`` stage of ``tpuflow.eval.profile_vo``); at
        # keyframe_stride=1 the ``fi % stride`` predicate folds to a
        # constant True and the cond never skips. The dead-slot
        # predicate makes the cond dynamic, so fully-tracked frames
        # skip the branch entirely while any death (or loss event)
        # reseeds exactly as before — bit-identical states either way.
        is_kf = ((fi % self.keyframe_stride) == 0) & jnp.any(
            jnp.logical_not(t.alive)
        )

        def reseed(args):
            xy, start, age, alive, lm, n_lm = args
            fresh = tracking.seed_grid(
                frame, grid_step=self.grid_step,
                margin=self.margin_for(*frame.shape, for_cull=False),
            )
            good = fresh.alive & jnp.logical_not(alive)
            new_ids = n_lm + jnp.cumsum(good.astype(jnp.int32)) - 1
            return (
                jnp.where(good[:, None], fresh.xy, xy),
                jnp.where(good[:, None], fresh.xy, start),
                jnp.where(good, 0, age),
                alive | good,
                jnp.where(good, new_ids, lm),
                n_lm + jnp.sum(good).astype(jnp.int32),
            )

        xy, start, age, alive, lm, n_lm = jax.lax.cond(
            is_kf,
            reseed,
            lambda args: args,
            (t.xy, t.start_xy, t.age, t.alive, state.track_lm,
             state.n_landmarks),
        )

        new_state = FrontEndState(
            carry=carry_curr,
            xy=xy, start_xy=start, age=age, alive=alive,
            track_lm=lm, n_landmarks=n_lm,
            frame_index=fi,
            max_alive=max_alive,
            tracking_lost=lost,
            loss_frames=loss_frames,
            loss_count=loss_count,
        )
        return new_state, ObsRecord(xy=xy, lm=lm, alive=alive, n_landmarks=n_lm)

    def _scan_steps(
        self, state: FrontEndState, frames: jax.Array
    ) -> tuple[FrontEndState, ObsRecord]:
        """Process a (T, H, W) frame chunk in ONE dispatch.

        Returns the final state and the T stacked ObsRecords; the caller
        slices out keyframe rows (device slices — still no sync).
        """
        return jax.lax.scan(self._step, state, frames)


@functools.lru_cache(maxsize=None)
def _shared_front_end(
    grid_step: int,
    keyframe_stride: int,
    fb_check_threshold: float | None,
    backend: str,
    config: PyramidConfig | None = None,
) -> FrontEnd:
    """Mesh-less FrontEnds are stateless given their config — share them
    so every OdometrySession with the same settings reuses one set of
    jitted (and compiled) functions instead of recompiling per session.
    PyramidConfig is a frozen dataclass, so it hashes into the cache
    key."""
    return FrontEnd(
        grid_step=grid_step,
        keyframe_stride=keyframe_stride,
        fb_check_threshold=fb_check_threshold,
        backend=backend,
        config=config,
    )


def get_front_end(
    grid_step: int,
    keyframe_stride: int,
    fb_check_threshold: float | None,
    backend: str,
    mesh=None,
    config: PyramidConfig | None = None,
) -> FrontEnd:
    if mesh is not None:
        # Meshes are unhashable runtime context; no sharing.
        return FrontEnd(
            grid_step=grid_step,
            keyframe_stride=keyframe_stride,
            fb_check_threshold=fb_check_threshold,
            backend=backend,
            mesh=mesh,
            config=config,
        )
    return _shared_front_end(
        grid_step, keyframe_stride, fb_check_threshold, backend, config
    )
