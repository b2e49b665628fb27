"""End-to-end visual-odometry pipeline: frames -> dense flow -> feature
tracks -> keyframe observations -> bundle-adjusted trajectory.

The integration layer over the front-end (tpuflow.flow dense LK +
tpuflow.vo.tracking) and back-end (tpuflow.vo.ba). Monocular: the
trajectory is recovered up to the usual 7-DOF gauge; landmarks are
initialized by back-projecting first observations at ``init_depth`` and
camera 0 is pinned, so reported translations are in units of
``init_depth`` scale.

Long sequences run through :class:`OdometrySession`, which processes
frames incrementally and can be checkpointed/resumed at any frame
boundary (tpuflow.vo.checkpoint) — the back-end state persistence the
reference has no counterpart for (SURVEY.md §5 "Checkpoint / resume").
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class OdometryResult:
    poses_r: np.ndarray      # (K, 3, 3) keyframe rotations
    poses_t: np.ndarray      # (K, 3) keyframe translations
    landmarks: np.ndarray    # (M, 3)
    keyframe_indices: list[int]
    track_count: int
    mean_reprojection_error: float
    # Frame indices where tracking was lost (alive fraction fell below
    # the session's loss threshold). Monocular trajectory segments
    # separated by a loss event are NOT metrically connected — after a
    # total occlusion the new segment re-anchors near the last pose
    # with fresh (unobservable) scale. Empty = continuous tracking.
    track_loss_frames: list[int] = dataclasses.field(default_factory=list)
    # Metric scale of the (otherwise gauge-free) monocular trajectory,
    # recovered by visual-inertial alignment when IMU samples with real
    # accelerometer content are supplied (vo.imu.estimate_scale_and_
    # gravity); None = unavailable/unreliable (|gravity| sanity check
    # failed). When ``metric_poses`` is False, multiply translations by
    # this to get world units; when True (imu_tight refinement ran,
    # tpuflow.vo.vi_graph), the poses are ALREADY metric and
    # ``metric_scale`` records the vision-to-metric factor applied.
    metric_scale: float | None = None
    metric_poses: bool = False


class OdometrySession:
    """Incremental VO: feed frames one at a time, solve/checkpoint anytime.

    The front-end (flow + tracking + loss detection + keyframe
    reseeding) runs entirely on device as one jitted step per frame
    (tpuflow.vo.device_loop) — zero host syncs on the hot path, the
    analog of the reference RTL never leaving the FPGA mid-pipeline
    (rtl/common/frame_buffer_simple.sv:60-94). Per-keyframe observation
    snapshots are appended as DEVICE arrays and materialized to NumPy
    lazily, only when the back-end needs them (solve / compact /
    checkpoint), so a session round-trips exactly through
    ``state_dict``/``from_state`` while the serving loop stays
    dispatch-only. ``process_frames`` scans whole frame chunks in a
    single dispatch.
    """

    def __init__(
        self,
        intrinsics: Sequence[float],
        keyframe_stride: int = 1,
        grid_step: int = 16,
        init_depth: float = 5.0,
        backend: str = "jnp",
        fb_check_threshold: float | None = None,
        mesh=None,
        pyramid_config: str = "default",
    ) -> None:
        from tpuflow.core.config import PYRAMID_CONFIGS
        from tpuflow.vo import device_loop

        self.intrinsics = tuple(float(x) for x in intrinsics)
        self.keyframe_stride = int(keyframe_stride)
        self.grid_step = int(grid_step)
        self.init_depth = float(init_depth)
        self.backend = backend
        # Named flow config for the front-end (the serving knob: e.g.
        # "adaptive_vertical" runs the VO flow at the production band
        # rate). Stored by NAME so it serializes into checkpoint meta.
        if pyramid_config not in PYRAMID_CONFIGS:
            raise ValueError(
                f"unknown pyramid config {pyramid_config!r}; available: "
                f"{', '.join(sorted(PYRAMID_CONFIGS))}"
            )
        self.pyramid_config = pyramid_config
        # Optional forward-backward flow consistency culling (px).
        self.fb_check_threshold = (
            None if fb_check_threshold is None else float(fb_check_threshold)
        )
        # Optional ("batch", "ty", "tx") mesh: large frames run the
        # front-end dense flow spatially tiled across devices with halo
        # exchange (BASELINE config 5: multi-host tiled flow feeding the
        # pose-graph/BA back-end). Tiled flow uses the fast-path
        # saturation semantics (backend "xla"); frame dims must divide the
        # mesh tiling. Runtime context only — not serialized; pass it
        # again to ``from_state``/``checkpoint.load`` on resume.
        self.mesh = mesh
        self._fe = device_loop.get_front_end(
            grid_step=self.grid_step,
            keyframe_stride=self.keyframe_stride,
            fb_check_threshold=self.fb_check_threshold,
            backend=backend,
            mesh=mesh,
            config=PYRAMID_CONFIGS[pyramid_config],
        )

        # Mutable state (set by start / from_state).
        self.frame_index = -1
        self.keyframes: list[int] = []
        # Device-resident front-end state + per-keyframe ObsRecords not
        # yet materialized: (global_frame_index, ObsRecord) pairs whose
        # arrays still live on device. ``_drain`` moves them into the
        # NumPy mirrors below in one batched transfer.
        self._dev = None                        # device_loop.FrontEndState
        self._pending: list[tuple] = []
        self._obs_uv: list[np.ndarray] = []     # per keyframe: (N, 2)
        self._obs_lm: list[np.ndarray] = []     # per keyframe: (N,) int32
        self._obs_valid: list[np.ndarray] = []  # per keyframe: (N,) bool
        # Landmark spawn records, reconstructed on drain: ids are
        # assigned monotonically on device, so a record's "new" ids are
        # exactly those >= the previous record's counter.
        self._lm_first_uv = np.zeros((0, 2), np.float32)
        self._lm_first_kf = np.zeros((0,), np.int32)
        self._n_lm_drained = 0
        # Marginalization state (compact()): frozen trajectory prefix,
        # anchor poses for the kept window, and solved landmark positions
        # carried across compactions as initialization/scale memory.
        self.frozen_kf: list[int] = []
        self.frozen_r = np.zeros((0, 3, 3), np.float32)
        self.frozen_t = np.zeros((0, 3), np.float32)
        self.anchor_r: np.ndarray | None = None  # (K_window, 3, 3)
        self.anchor_t: np.ndarray | None = None  # (K_window, 3)
        self.lm_xyz: np.ndarray | None = None    # (n_landmarks_kept, 3)

    # -- lifecycle ---------------------------------------------------------

    def start(self, first_frame: np.ndarray) -> None:
        """Seed features on the first frame and record keyframe 0."""
        self._dev, obs0 = self._fe.init(
            np.asarray(first_frame, np.float32)
        )
        self.frame_index = 0
        self.keyframes = [0]
        self._pending.append((0, obs0))

    def process_frame(self, frame: np.ndarray) -> None:
        """Advance tracks by dense flow prev->frame; record on keyframes.

        One device dispatch, no host readback: flow, track advance,
        optional fb-check, loss detection, and keyframe reseeding all
        happen inside the jitted step; the keyframe decision is
        host-predictable (frame_index % keyframe_stride) so even the
        observation snapshot is kept as device arrays."""
        if self.frame_index < 0:
            self.start(frame)
            return
        self._dev, obs = self._fe.step(
            self._dev, np.asarray(frame, np.float32)
        )
        self.frame_index += 1
        if self.frame_index % self.keyframe_stride == 0:
            self.keyframes.append(self.frame_index)
            self._pending.append((self.frame_index, obs))

    def process_frames(self, frames) -> None:
        """Process a whole (T, H, W) frame chunk in ONE device dispatch.

        ``lax.scan`` over the same step ``process_frame`` runs —
        identical results, but dispatch overhead is paid once per chunk
        instead of once per frame. The chunk must fit in device memory
        alongside the model
        (T*H*W*4 bytes); chunk long clips accordingly."""
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 3:
            raise ValueError(f"expected (T, H, W) frames, got {frames.shape}")
        if self.frame_index < 0:
            self.start(frames[0])
            frames = frames[1:]
        if frames.shape[0] == 0:
            return
        import jax

        self._dev, obs_stack = self._fe.scan_steps(self._dev, frames)
        first = self.frame_index + 1
        for i in range(frames.shape[0]):
            fi = first + i
            if fi % self.keyframe_stride == 0:
                self.keyframes.append(fi)
                # Device-side row slice — still no host sync.
                self._pending.append(
                    (fi, jax.tree.map(lambda a: a[i], obs_stack))
                )
        self.frame_index += frames.shape[0]

    # -- lazy host materialization ------------------------------------------

    def _drain(self) -> None:
        """Materialize pending device ObsRecords into the NumPy mirrors
        (one batched device_get), reconstructing landmark spawn records
        from the monotone id counter."""
        if not self._pending:
            return
        import jax

        recs = jax.device_get([rec for _, rec in self._pending])
        for (gfi, _), rec in zip(self._pending, recs):
            xy = np.asarray(rec.xy, np.float32)
            lm = np.asarray(rec.lm, np.int32)
            alive = np.asarray(rec.alive, bool)
            n_lm = int(rec.n_landmarks)
            self._obs_uv.append(xy)
            self._obs_lm.append(lm)
            self._obs_valid.append(alive)
            if n_lm > self._n_lm_drained:
                # Ids >= the previous counter were assigned at this
                # keyframe; their first observation is this record's
                # position at the slot that carries them. Ids ascend in
                # slot order, so the sort is a stable identity — kept
                # for robustness.
                new = lm >= self._n_lm_drained
                slots = np.where(new)[0]
                order = np.argsort(lm[slots], kind="stable")
                self._lm_first_uv = np.concatenate(
                    [self._lm_first_uv, xy[slots][order]], axis=0
                )
                self._lm_first_kf = np.concatenate(
                    [self._lm_first_kf,
                     np.full(len(slots), gfi, np.int32)]
                )
                self._n_lm_drained = n_lm
        self._pending.clear()

    # Back-end-facing views. Getters drain pending device records;
    # setters exist for compact()'s in-place rewrites and keep the
    # device state (landmark counter, slot->id table) in sync.

    @property
    def obs_uv(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_uv

    @obs_uv.setter
    def obs_uv(self, v) -> None:
        self._obs_uv = list(v)

    @property
    def obs_lm(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_lm

    @obs_lm.setter
    def obs_lm(self, v) -> None:
        self._obs_lm = list(v)

    @property
    def obs_valid(self) -> list[np.ndarray]:
        self._drain()
        return self._obs_valid

    @obs_valid.setter
    def obs_valid(self, v) -> None:
        self._obs_valid = list(v)

    @property
    def lm_first_uv(self) -> np.ndarray:
        self._drain()
        return self._lm_first_uv

    @lm_first_uv.setter
    def lm_first_uv(self, v) -> None:
        self._lm_first_uv = np.asarray(v, np.float32)

    @property
    def lm_first_kf(self) -> np.ndarray:
        self._drain()
        return self._lm_first_kf

    @lm_first_kf.setter
    def lm_first_kf(self, v) -> None:
        self._lm_first_kf = np.asarray(v, np.int32)

    @property
    def n_landmarks(self) -> int:
        self._drain()
        return self._n_lm_drained

    @n_landmarks.setter
    def n_landmarks(self, v: int) -> None:
        import jax.numpy as jnp

        self._n_lm_drained = int(v)
        if self._dev is not None:
            self._dev = self._dev._replace(
                n_landmarks=jnp.asarray(int(v), jnp.int32)
            )

    @property
    def track_lm(self) -> np.ndarray:
        """Current slot -> landmark id table (device readback)."""
        return np.asarray(self._dev.track_lm, np.int32)

    @track_lm.setter
    def track_lm(self, v) -> None:
        import jax.numpy as jnp

        self._dev = self._dev._replace(
            track_lm=jnp.asarray(np.asarray(v, np.int32))
        )

    @property
    def track_loss_frames(self) -> list[int]:
        """Frame indices of healthy->lost transitions (device event log;
        reading costs one small readback)."""
        if self._dev is None:
            return []
        import jax

        log, count = jax.device_get(
            (self._dev.loss_frames, self._dev.loss_count)
        )
        return [int(x) for x in log[: int(count)]]

    @property
    def _tracking_lost(self) -> bool:
        if self._dev is None:
            return False
        return bool(np.asarray(self._dev.tracking_lost))

    @property
    def _max_alive(self) -> int:
        if self._dev is None:
            return 0
        return int(np.asarray(self._dev.max_alive))

    @property
    def _tracks(self):
        """Live track table as a tracking.Tracks of device arrays."""
        from tpuflow.vo import tracking

        if self._dev is None:
            return None
        return tracking.Tracks(
            xy=self._dev.xy,
            start_xy=self._dev.start_xy,
            age=self._dev.age,
            alive=self._dev.alive,
        )

    @property
    def _prev_frame(self):
        """The last processed frame (device array). The untiled carry is
        the frame's Gaussian pyramid ordered coarse->fine, so the raw
        frame is its finest level."""
        if self._dev is None:
            return None
        return self._dev.carry[0] if self.mesh is not None \
            else self._dev.carry[-1]

    # -- solve -------------------------------------------------------------

    def _essential_initial_poses(self) -> tuple[np.ndarray, np.ndarray]:
        """Closed-form pose chain from per-edge essential matrices.

        For each consecutive keyframe pair: match observation slots that
        kept the same landmark id, run the jitted 8-point + cheirality
        pipeline (tpuflow.vo.epipolar.two_view_init), and chain the
        relative poses. Monocular per-edge scale is propagated by the
        depth ratio of landmarks shared with the previous edge; the
        first edge is scaled so the median triangulated depth equals
        ``init_depth`` (the session's monocular gauge convention).
        Degenerate edges (too few matches, ~zero pixel motion, or a
        losing cheirality vote) fall back to an identity relative pose.
        """
        import jax.numpy as jnp

        from tpuflow.vo import epipolar, se3

        k = len(self.keyframes)
        intr = jnp.asarray(self.intrinsics, jnp.float32)
        pr = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
        pt = np.zeros((k, 3), np.float32)
        if self.anchor_r is not None and self.anchor_r.shape[0] > 0:
            # Post-compaction: the chain continues from the anchored
            # first window pose (gauge continuity with the frozen prefix).
            pr[:] = self.anchor_r[0]
            pt[:] = self.anchor_t[0]
        prev_edge = None  # (lm_ids, points_unit (N,3), rel_r, rel_t, scale)
        scale = 1.0
        for e in range(k - 1):
            valid = (
                self.obs_valid[e]
                & self.obs_valid[e + 1]
                & (self.obs_lm[e] == self.obs_lm[e + 1])
            )
            uv1 = self.obs_uv[e]
            uv2 = self.obs_uv[e + 1]
            disp = np.linalg.norm(uv2 - uv1, axis=1)
            moved = float(np.median(disp[valid])) if valid.any() else 0.0
            if int(valid.sum()) < 8 or moved < 0.5:
                # Near-degenerate: keep the previous pose (identity edge).
                pr[e + 1] = pr[e]
                pt[e + 1] = pt[e]
                prev_edge = None
                continue
            init = epipolar.two_view_init(
                jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid), intr
            )
            n_good = int(init.n_good)
            if n_good < max(8, 0.5 * int(valid.sum())):
                pr[e + 1] = pr[e]
                pt[e + 1] = pt[e]
                prev_edge = None
                continue
            rel_r = np.asarray(init.r)
            rel_t = np.asarray(init.t)
            depths = np.asarray(init.depths1)
            good = np.asarray(init.good)
            x1 = np.asarray(
                epipolar.normalize_pixels(jnp.asarray(uv1), intr)
            )
            pts_unit = (
                np.concatenate([x1, np.ones((x1.shape[0], 1))], axis=1)
                * depths[:, None]
            ).astype(np.float32)

            if prev_edge is None:
                scale = self.init_depth / max(
                    float(np.median(depths[good])), 1e-6
                )
            else:
                p_ids, p_pts, p_r, p_t, p_scale = prev_edge
                common = (
                    good
                    & p_ids[1]
                    & (self.obs_lm[e] == p_ids[0])
                )
                if int(common.sum()) >= 4:
                    # Previous edge's points, moved into this frame and
                    # scaled: depth each shared landmark *should* have.
                    z_prev = p_scale * (p_pts[common] @ p_r.T + p_t)[:, 2]
                    z_cur = depths[common]
                    ratio = z_prev / np.maximum(z_cur, 1e-6)
                    ratio = ratio[(z_prev > 1e-6) & (z_cur > 1e-6)]
                    if ratio.size >= 4:
                        scale = float(np.median(ratio))
            rj, tj = se3.compose(
                jnp.asarray(rel_r), jnp.asarray(rel_t * scale),
                jnp.asarray(pr[e]), jnp.asarray(pt[e]),
            )
            pr[e + 1] = np.asarray(rj)
            pt[e + 1] = np.asarray(tj)
            prev_edge = (
                (self.obs_lm[e].copy(), good), pts_unit, rel_r, rel_t, scale
            )
        return pr, pt

    def solve(
        self,
        ba_iterations: int = 8,
        window: int | None = None,
        essential_init: bool = False,
    ) -> OdometryResult:
        """Bundle-adjust the keyframe poses recorded so far.

        ``window``: if set, only the most recent ``window`` keyframes are
        free — older poses are held fixed (sliding-window BA for long
        sequences; landmarks stay free so re-observed old landmarks keep
        constraining the window). Camera 0 is always pinned (gauge).

        ``essential_init``: bootstrap poses from per-edge essential-
        matrix decompositions and landmarks from multi-view linear
        triangulation instead of identity/flat-depth — the large-
        baseline initialization (tpuflow.vo.epipolar).
        """
        import jax.numpy as jnp

        from tpuflow.vo import ba

        fx, fy, cx, cy = self.intrinsics
        k = len(self.keyframes)
        n_tracks = self.obs_uv[0].shape[0]
        uv = np.concatenate(self.obs_uv)
        cam = np.concatenate(
            [np.full(n_tracks, i, np.int32) for i in range(k)]
        )
        lm_idx = np.concatenate(self.obs_lm)
        valid = np.concatenate(self.obs_valid)

        # Initial poses: essential chain > compaction anchors > identity.
        if essential_init and k >= 2:
            pr0, pt0 = self._essential_initial_poses()
        elif self.anchor_r is not None:
            na = self.anchor_r.shape[0]
            pr0 = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
            pt0 = np.zeros((k, 3), np.float32)
            pr0[: min(na, k)] = self.anchor_r[:k]
            pt0[: min(na, k)] = self.anchor_t[:k]
            # Keyframes recorded after the last compact(): start at the
            # last anchored pose (better than identity; BA refines).
            for c in range(min(na, k), k):
                pr0[c] = pr0[c - 1]
                pt0[c] = pt0[c - 1]
        else:
            pr0 = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
            pt0 = np.zeros((k, 3), np.float32)

        # Initial landmarks: back-project each landmark's first
        # observation at the initialization depth *through the initial
        # pose of its spawning keyframe* (monocular scale convention;
        # reduces to the flat identity-frame back-projection when all
        # poses initialize at identity). Landmarks carried through
        # compact() instead reuse their previously solved positions.
        first = self.lm_first_uv
        n_lm = self.n_landmarks
        kf_ord = {g: i for i, g in enumerate(self.keyframes)}
        spawn_ord = np.asarray(
            [kf_ord.get(int(g), 0) for g in self.lm_first_kf], np.int32
        )
        ray = np.stack(
            [
                (first[:, 0] - cx) / fx * self.init_depth,
                (first[:, 1] - cy) / fy * self.init_depth,
                np.full(n_lm, self.init_depth, np.float32),
            ],
            axis=1,
        ).astype(np.float32)
        rs = pr0[spawn_ord]                       # (M, 3, 3)
        ts = pt0[spawn_ord]                       # (M, 3)
        landmarks = np.einsum("mij,mi->mj", rs, ray - ts).astype(np.float32)
        if self.lm_xyz is not None and self.lm_xyz.shape[0] > 0:
            nk = min(self.lm_xyz.shape[0], n_lm)
            landmarks[:nk] = self.lm_xyz[:nk]

        init_r = jnp.asarray(pr0)
        init_t = jnp.asarray(pt0)
        if essential_init and k >= 2:
            from tpuflow.vo import epipolar

            lm0 = epipolar.triangulate_landmarks(
                init_r, init_t,
                jnp.asarray(uv, jnp.float32), jnp.asarray(cam),
                jnp.asarray(lm_idx), jnp.asarray(valid),
                jnp.asarray(self.intrinsics, jnp.float32),
                n_landmarks=n_lm,
                fallback=jnp.asarray(landmarks),
            )
        else:
            lm0 = jnp.asarray(landmarks)

        problem = ba.BAProblem(
            poses_r=init_r,
            poses_t=init_t,
            landmarks=lm0,
            obs_uv=jnp.asarray(uv, jnp.float32),
            obs_cam=jnp.asarray(cam),
            obs_lm=jnp.asarray(lm_idx),
            obs_valid=jnp.asarray(valid),
            intrinsics=jnp.asarray(self.intrinsics, jnp.float32),
        )
        if window is not None and k > window:
            fixed = tuple(range(k - window))  # includes camera 0
        elif (
            self.anchor_r is not None
            and self.anchor_r.shape[0] >= 2
            and k >= 2
        ):
            # Post-compaction gauge: the anchored first two window poses
            # pin the full 7-DOF monocular gauge (pose + scale), keeping
            # the frozen prefix and the refined window in one frame.
            fixed = (0, 1)
        else:
            fixed = (0,)
        solved = ba.solve(
            problem, iterations=ba_iterations, fixed_cams=fixed
        )
        err = ba.reprojection_errors(solved)
        alive = np.asarray(problem.obs_valid)
        mean_err = float(np.asarray(err)[alive].mean()) if alive.any() else 0.0

        return OdometryResult(
            poses_r=np.concatenate(
                [self.frozen_r, np.asarray(solved.poses_r)]
            ),
            poses_t=np.concatenate(
                [self.frozen_t, np.asarray(solved.poses_t)]
            ),
            landmarks=np.asarray(solved.landmarks),
            keyframe_indices=self.frozen_kf + list(self.keyframes),
            track_count=int(np.asarray(self._tracks.alive).sum()),
            mean_reprojection_error=mean_err,
            track_loss_frames=list(self.track_loss_frames),
        )

    def compact(
        self,
        keep_last: int,
        ba_iterations: int = 8,
        essential_init: bool = False,
    ) -> None:
        """Marginalize keyframes older than the last ``keep_last``.

        Bounded-memory sliding-window sessions (SURVEY.md §5 has no
        reference counterpart — this is back-end machinery): solve BA
        over the current window once, then (1) freeze the solved poses of
        the keyframes leaving the window into the trajectory prefix,
        (2) drop their observation records, (3) remap landmark ids so
        only window-visible + live-track landmarks remain (the memory
        bound), and (4) anchor the kept poses and carry the solved
        landmark positions as the next solve's initialization and
        gauge/scale memory. This is marginalization by fixation (drop +
        anchor, the DSO-style approximation), not a dense Schur prior:
        correlations between dropped and kept states are approximated by
        pinning the first two kept poses.
        """
        k = len(self.keyframes)
        if k <= keep_last:
            return
        res = self.solve(
            ba_iterations=ba_iterations, essential_init=essential_init
        )
        nf = len(self.frozen_kf)
        win_r = res.poses_r[nf:]
        win_t = res.poses_t[nf:]
        ndrop = k - keep_last

        self.frozen_kf += self.keyframes[:ndrop]
        self.frozen_r = np.concatenate([self.frozen_r, win_r[:ndrop]])
        self.frozen_t = np.concatenate([self.frozen_t, win_t[:ndrop]])
        self.keyframes = self.keyframes[ndrop:]
        self.obs_uv = self.obs_uv[ndrop:]
        self.obs_lm = self.obs_lm[ndrop:]
        self.obs_valid = self.obs_valid[ndrop:]
        self.anchor_r = win_r[ndrop:].copy()
        self.anchor_t = win_t[ndrop:].copy()

        # Landmark compaction: keep ids observed (validly) in the window
        # or carried by a live track slot; remap to dense ids.
        used = [lm[v] for lm, v in zip(self.obs_lm, self.obs_valid)]
        alive = np.asarray(self._tracks.alive)
        used.append(self.track_lm[alive])
        kept = np.unique(np.concatenate(used)).astype(np.int32)
        old2new = np.full(self.n_landmarks, -1, np.int32)
        old2new[kept] = np.arange(len(kept), dtype=np.int32)
        for i in range(len(self.obs_lm)):
            m = old2new[self.obs_lm[i]]
            self.obs_valid[i] = self.obs_valid[i] & (m >= 0)
            self.obs_lm[i] = np.where(m >= 0, m, 0).astype(np.int32)
        tm = old2new[self.track_lm]
        self.track_lm = np.where(tm >= 0, tm, 0).astype(np.int32)
        self.lm_first_uv = self.lm_first_uv[kept]
        self.lm_first_kf = self.lm_first_kf[kept]
        self.lm_xyz = res.landmarks[kept].astype(np.float32)
        self.n_landmarks = len(kept)

    # -- checkpointable state ---------------------------------------------

    def state_dict(self) -> dict:
        """Array-only pytree capturing the full resumable state.

        Materializes the device-resident front-end state (the one
        intentional full sync point besides solve)."""
        t = self._tracks
        state = {
            "frame_index": np.int64(self.frame_index),
            "keyframes": np.asarray(self.keyframes, np.int64),
            # One convention for every optional array: OMITTED while
            # empty (the size filter below — Orbax rejects zero-size
            # arrays), defaulted by ``from_state``.
            "track_loss_frames": np.asarray(self.track_loss_frames, np.int64),
            "tracking_lost": np.int64(self._tracking_lost),
            "max_alive": np.int64(self._max_alive),
            "obs_uv": np.stack(self.obs_uv),          # (K, N, 2)
            "obs_lm": np.stack(self.obs_lm),          # (K, N)
            "obs_valid": np.stack(self.obs_valid),    # (K, N)
            "prev_frame": np.asarray(self._prev_frame, np.float32),
            "tracks_xy": np.asarray(t.xy, np.float32),
            "tracks_start_xy": np.asarray(t.start_xy, np.float32),
            "tracks_age": np.asarray(t.age, np.int32),
            "tracks_alive": np.asarray(t.alive, bool),
            "track_lm": np.asarray(self.track_lm, np.int32),
            "lm_first_uv": np.asarray(self.lm_first_uv, np.float32),
            "lm_first_kf": np.asarray(self.lm_first_kf, np.int32),
            "n_landmarks": np.int64(self.n_landmarks),
            # Marginalization state. Keys are OMITTED while unset
            # (fresh sessions, pre-compact()): Orbax rejects zero-size
            # arrays, and ``from_state`` defaults every absent key to
            # the empty/None initial state.
            "frozen_kf": np.asarray(self.frozen_kf, np.int64),
            "frozen_r": self.frozen_r,
            "frozen_t": self.frozen_t,
            "anchor_r": self.anchor_r,
            "anchor_t": self.anchor_t,
            "lm_xyz": self.lm_xyz,
        }
        return {
            k: v
            for k, v in state.items()
            if v is not None and (not isinstance(v, np.ndarray) or v.size)
        }

    def meta_dict(self) -> dict:
        """JSON-able static configuration."""
        return {
            "intrinsics": list(self.intrinsics),
            "keyframe_stride": self.keyframe_stride,
            "grid_step": self.grid_step,
            "init_depth": self.init_depth,
            "backend": self.backend,
            "fb_check_threshold": self.fb_check_threshold,
            "tiled": self.mesh is not None,
            "pyramid_config": self.pyramid_config,
        }

    @classmethod
    def from_state(cls, meta: dict, state: dict, mesh=None) -> "OdometrySession":
        import jax.numpy as jnp

        from tpuflow.vo import device_loop

        # Tiled and untiled flow differ in saturation semantics
        # (fast path vs golden); silently switching on resume would
        # break the bit-identical-resume contract.
        was_tiled = bool(meta.get("tiled", False))
        if was_tiled and mesh is None:
            raise ValueError(
                "this session used mesh-tiled flow; pass the mesh to "
                "from_state/checkpoint.load to resume (tiled flow's "
                "saturation semantics differ from the untiled default)"
            )
        if not was_tiled and mesh is not None:
            raise ValueError(
                "this session used untiled flow; resuming with a mesh "
                "would switch flow semantics mid-session"
            )
        sess = cls(
            intrinsics=meta["intrinsics"],
            keyframe_stride=meta["keyframe_stride"],
            grid_step=meta["grid_step"],
            init_depth=meta["init_depth"],
            backend=meta["backend"],
            fb_check_threshold=meta.get("fb_check_threshold"),
            mesh=mesh,
            pyramid_config=meta.get("pyramid_config", "default"),
        )
        sess.frame_index = int(state["frame_index"])
        sess.keyframes = [int(x) for x in np.asarray(state["keyframes"])]
        sess.obs_uv = [
            np.asarray(x, np.float32) for x in np.asarray(state["obs_uv"])
        ]
        sess.obs_lm = [
            np.asarray(x, np.int32) for x in np.asarray(state["obs_lm"])
        ]
        sess.obs_valid = [
            np.asarray(x, bool) for x in np.asarray(state["obs_valid"])
        ]
        sess.lm_first_uv = np.asarray(state["lm_first_uv"], np.float32)
        sess.lm_first_kf = np.asarray(
            state.get("lm_first_kf", np.zeros(len(sess.lm_first_uv))),
            np.int32,
        )
        sess._n_lm_drained = int(state["n_landmarks"])
        sess.frozen_kf = [
            int(x) for x in np.asarray(state.get("frozen_kf", []))
        ]
        sess.frozen_r = np.asarray(
            state.get("frozen_r", np.zeros((0, 3, 3))), np.float32
        )
        sess.frozen_t = np.asarray(
            state.get("frozen_t", np.zeros((0, 3))), np.float32
        )
        anchor_r = np.asarray(
            state.get("anchor_r", np.zeros((0, 3, 3))), np.float32
        )
        anchor_t = np.asarray(
            state.get("anchor_t", np.zeros((0, 3))), np.float32
        )
        sess.anchor_r = anchor_r if anchor_r.shape[0] else None
        sess.anchor_t = anchor_t if anchor_t.shape[0] else None
        lm_xyz = np.asarray(state.get("lm_xyz", np.zeros((0, 3))), np.float32)
        sess.lm_xyz = lm_xyz if lm_xyz.shape[0] else None

        # Rebuild the device-resident front-end state. The flow carry is
        # recomputed from the saved previous frame — a pure function of
        # it, so the resume stays bit-identical. The >= 0 filter on the
        # loss log also accepts pre-round-3 checkpoints that encoded
        # "empty" as a [-1] sentinel instead of an omitted key.
        losses = [
            int(x) for x in np.asarray(state.get("track_loss_frames", []))
            if int(x) >= 0
        ]
        cap = device_loop.LOSS_LOG_CAP
        log = np.full((cap,), -1, np.int32)
        log[: min(len(losses), cap)] = losses[:cap]
        sess._dev = device_loop.FrontEndState(
            carry=sess._fe.carry_of_frame(
                jnp.asarray(state["prev_frame"], jnp.float32)
            ),
            xy=jnp.asarray(state["tracks_xy"], jnp.float32),
            start_xy=jnp.asarray(state["tracks_start_xy"], jnp.float32),
            age=jnp.asarray(state["tracks_age"], jnp.int32),
            alive=jnp.asarray(np.asarray(state["tracks_alive"], bool)),
            track_lm=jnp.asarray(state["track_lm"], jnp.int32),
            n_landmarks=jnp.asarray(int(state["n_landmarks"]), jnp.int32),
            frame_index=jnp.asarray(sess.frame_index, jnp.int32),
            max_alive=jnp.asarray(
                int(state.get("max_alive", 0)), jnp.int32
            ),
            tracking_lost=jnp.asarray(
                bool(int(state.get("tracking_lost", 0)))
            ),
            loss_frames=jnp.asarray(log),
            loss_count=jnp.asarray(len(losses), jnp.int32),
        )
        return sess


def run_odometry(
    frames: Sequence[np.ndarray],
    intrinsics: Sequence[float],
    keyframe_stride: int = 1,
    grid_step: int = 16,
    init_depth: float = 5.0,
    ba_iterations: int = 8,
    backend: str = "jnp",
    fb_check_threshold: float | None = None,
    pyramid_config: str = "default",
) -> OdometryResult:
    """Track through ``frames`` and bundle-adjust the keyframe poses.

    frames: grayscale float32 arrays (all the same shape).
    intrinsics: (fx, fy, cx, cy).
    """
    session = OdometrySession(
        intrinsics,
        keyframe_stride=keyframe_stride,
        grid_step=grid_step,
        init_depth=init_depth,
        backend=backend,
        fb_check_threshold=fb_check_threshold,
        pyramid_config=pyramid_config,
    )
    for frame in frames:
        session.process_frame(frame)
    return session.solve(ba_iterations=ba_iterations)


def run_odometry_chunked(
    frames: Sequence[np.ndarray],
    intrinsics: Sequence[float],
    chunk_size: int = 6,
    overlap: int = 2,
    grid_step: int = 16,
    init_depth: float = 5.0,
    ba_iterations: int = 8,
    pg_iterations: int = 15,
    backend: str = "jnp",
    loop_closure: bool = False,
    loop_threshold: float = 0.95,
    loop_min_separation: int = 4,
    loop_weight: float = 5.0,
    motion_prior_weight: float = 0.0,
    fb_check_threshold: float | None = None,
    pyramid_config: str = "default",
    imu: tuple | None = None,
    frame_times: "np.ndarray | None" = None,
    imu_weight: float = 2.0,
    imu_r_cam: "np.ndarray | None" = None,
    imu_tight: bool = False,
) -> "OdometryResult":
    """Local-BA + global pose-graph odometry (the classic SLAM split).

    Frames are processed in overlapping chunks: each chunk runs dense
    flow -> tracks -> bundle adjustment independently (bounded problem
    size, chunks could run in parallel), producing relative poses
    between its consecutive keyframes. Chunk scales (the monocular gauge
    freedom of each local solve) are chained through the shared overlap
    edge, then all relative-pose constraints are fused by global
    pose-graph Gauss-Newton (tpuflow.vo.pose_graph) — the "keyframe
    pose-graph optimization" stage of the BASELINE north star, fed by
    the BA front-end rather than replacing it.

    ``overlap`` must be >= 2 so consecutive chunks share one relative
    pose for scale chaining.

    ``loop_closure``: detect appearance-based revisits
    (tpuflow.vo.loop_closure thumbnail descriptors, cosine >=
    ``loop_threshold``, at least ``loop_min_separation`` keyframes
    apart), measure each pair's relative pose from dense flow +
    essential decomposition, and add the edges (information scale
    ``loop_weight``) to the pose graph — cancelling odometry drift on
    revisits.

    ``motion_prior_weight``: if > 0, append soft constant-velocity
    edges (pose_graph.constant_velocity_edges) that regularize
    keyframes with weak constraints toward the smooth trajectory
    predicted by their neighbors.

    ``imu``: optional ``(times, gyro, accel)`` sample arrays
    (tpuflow.io.imu format). With ``frame_times`` (per-frame
    timestamps), the gyro stream is preintegrated between consecutive
    keyframes (tpuflow.vo.imu) and added as rotation-only pose-graph
    edges with information scale ``imu_weight`` — gyro-aided rotation
    drift correction. ``imu_r_cam``: camera-from-IMU rotation extrinsic.

    ``imu_tight``: additionally run the tightly-coupled VI refinement
    (tpuflow.vo.vi_graph) after the pose-graph solve — keyframe poses
    AND velocities re-optimized under preintegrated IMU factors with the
    gravity recovered by the linear alignment; the returned poses are
    then METRIC (``metric_poses=True``, translations in world units).
    Requires full IMU coverage of every keyframe interval and a
    physically-plausible recovered gravity; falls back to the loose
    scale report otherwise.
    """
    import jax
    import jax.numpy as jnp

    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.vo import loop_closure as lc
    from tpuflow.vo import pose_graph, se3

    if overlap < 2:
        raise ValueError("overlap must be >= 2 for scale chaining")
    n = len(frames)
    step = chunk_size - overlap + 1
    starts = list(range(0, max(n - chunk_size, 0) + 1, step - 1 if step > 1 else 1))
    if starts[-1] + chunk_size < n:
        starts.append(n - chunk_size)

    def rel(pr, pt, i, j):
        """T_i^-1 o T_j (the pose-graph edge measurement convention)."""
        ri, ti = se3.inverse(jnp.asarray(pr[i]), jnp.asarray(pt[i]))
        return se3.compose(ri, ti, jnp.asarray(pr[j]), jnp.asarray(pt[j]))

    imu_arrays = None
    if imu is not None:
        if frame_times is None:
            raise ValueError("imu requires frame_times (per-frame timestamps)")
        from tpuflow.vo import imu as imu_mod

        imu_arrays = imu
        frame_times = np.asarray(frame_times, np.float64)

    def _chunk_metric_scale(res, kf_global):
        """Per-chunk metric scale from the linear VI alignment.

        The |t|-ratio scale chain divides by the shared edge's
        translation norm — near-zero at motion turning points (e.g. the
        swing sequence reverses inside a chunk boundary), which garbles
        every later chunk's scale. With an accelerometer available each
        chunk's scale is observable DIRECTLY; chaining is only the
        fallback."""
        if imu_arrays is None or len(kf_global) < 4:
            return None
        imu_t, imu_gyro, imu_accel = imu_arrays
        kf_times = frame_times[np.asarray(kf_global)]
        incs = imu_mod.preintegrate_segments(
            imu_t, imu_gyro, imu_accel, kf_times
        )
        if any(int(inc.n_samples) == 0 for inc in incs):
            return None
        try:
            s_c, g_c, _v, _rms = imu_mod.estimate_scale_and_gravity(
                res.poses_r, res.poses_t, incs, r_cam_imu=imu_r_cam
            )
        except np.linalg.LinAlgError:
            return None
        if 8.0 < float(np.linalg.norm(g_c)) < 12.0 and s_c > 0:
            return float(s_c)
        return None

    edges = {}  # (gi, gj) -> (R, t)
    scale = 1.0
    prev_shared = None  # ((gi, gj), |t| in previous chunk's scale)
    chunk0_metric = None  # chunk 0's units -> metric (for the fallback)
    last_result = None
    # Loss frames are detected per chunk with LOCAL frame indices;
    # collect them as global indices, deduping across chunk overlaps
    # (the same occluded frame is seen by up to two chunks).
    loss_frames: set[int] = set()
    for s in starts:
        res = run_odometry(
            frames[s : s + chunk_size], intrinsics,
            grid_step=grid_step, init_depth=init_depth,
            ba_iterations=ba_iterations, backend=backend,
            fb_check_threshold=fb_check_threshold,
            pyramid_config=pyramid_config,
        )
        last_result = res
        loss_frames.update(s + f for f in res.track_loss_frames)
        kf = [s + i for i in res.keyframe_indices]
        rels = [
            (kf[i], kf[i + 1], rel(res.poses_r, res.poses_t, i, i + 1))
            for i in range(len(kf) - 1)
        ]
        if prev_shared is None:
            # First chunk defines the trajectory's working units; cache
            # its metric scale so a later degenerate-boundary fallback
            # can re-express a chunk in CHUNK-0 units (not raw metric —
            # mixing units would put a scale kink at the boundary).
            chunk0_metric = _chunk_metric_scale(res, kf)
        else:
            # Primary: |t|-ratio chaining through the shared overlap
            # edge (keeps the chunks' RELATIVE scales consistent — the
            # vision shape is self-consistent even when its absolute
            # scale is not). Degenerate when the shared edge's
            # translation is tiny (motion turning point at a chunk
            # boundary): the division amplifies noise and garbles every
            # later chunk — there, fall back to the chunk's IMU-anchored
            # metric scale divided by chunk 0's (both available only
            # with an accelerometer; measured on the swing sequence the
            # chained tail collapsed to ~0.3x of truth before this
            # fallback). A merely SMALL-but-measured shared edge without
            # IMU keeps the old chain behavior (tn > 1e-9).
            (gi, gj), prev_norm = prev_shared
            match = [r for r in rels if (r[0], r[1]) == (gi, gj)]
            tn = (
                float(np.linalg.norm(np.asarray(match[0][2][1])))
                if match else 0.0
            )
            typical = float(np.median(
                [np.linalg.norm(np.asarray(t_)) for _a, _b, (_r, t_) in rels]
            ))
            metric_chunk_scale = None
            if tn <= 0.2 * typical and chunk0_metric is not None:
                s_c = _chunk_metric_scale(res, kf)
                if s_c is not None:
                    metric_chunk_scale = s_c / chunk0_metric
            if metric_chunk_scale is not None:
                scale = metric_chunk_scale
            elif tn > 1e-9:
                scale *= prev_norm / tn
        for gi, gj, (rr, tt) in rels:
            if (gi, gj) not in edges:
                edges[(gi, gj)] = (np.asarray(rr), np.asarray(tt) * scale)
        last_gi, last_gj, (rr, tt) = rels[-1]
        prev_shared = (
            (last_gi, last_gj),
            float(np.linalg.norm(np.asarray(tt))) * scale,
        )

    # Global keyframe set + sequential initialization by chaining edges.
    nodes = sorted({i for ij in edges for i in ij})
    idx = {g: k for k, g in enumerate(nodes)}
    k = len(nodes)

    # Loop closures: appearance retrieval over keyframe thumbnails, then
    # a measured relative-pose edge per accepted revisit pair.
    loop_edges: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    if loop_closure and k > loop_min_separation:
        descs = np.stack(
            [lc.keyframe_descriptor(frames[g]) for g in nodes]
        )
        pairs = lc.detect_loops(
            descs,
            min_separation=loop_min_separation,
            threshold=loop_threshold,
        )
        flow_fn = jax.jit(
            lambda p, c: lucas_kanade_pyramidal(p, c, backend=backend)
        )
        for i, j, _sim in pairs:
            gi, gj = nodes[i], nodes[j]
            if (gi, gj) in edges:
                continue
            measured = lc.loop_edge(
                frames[gi], frames[gj], intrinsics, flow_fn,
                depth=init_depth, grid_step=grid_step,
            )
            if measured is not None:
                loop_edges[(gi, gj)] = (measured[0], measured[1])
    pr = np.tile(np.eye(3, dtype=np.float32)[None], (k, 1, 1))
    pt = np.zeros((k, 3), np.float32)
    for (gi, gj), (rr, tt) in sorted(edges.items()):
        i, j = idx[gi], idx[gj]
        rj, tj = se3.compose(
            jnp.asarray(pr[i]), jnp.asarray(pt[i]),
            jnp.asarray(rr), jnp.asarray(tt),
        )
        pr[j] = np.asarray(rj)
        pt[j] = np.asarray(tj)

    all_edges = dict(edges)
    all_edges.update(loop_edges)
    weights = np.concatenate(
        [
            np.ones(len(edges), np.float32),
            np.full(len(loop_edges), loop_weight, np.float32),
        ]
    )
    ei = np.asarray([idx[a] for (a, _b) in all_edges], np.int32)
    ej = np.asarray([idx[b] for (_a, b) in all_edges], np.int32)
    er = np.stack([e[0] for e in all_edges.values()])
    et = np.stack([e[1] for e in all_edges.values()])
    g = pose_graph.PoseGraph(
        poses_r=jnp.asarray(pr),
        poses_t=jnp.asarray(pt),
        edge_i=jnp.asarray(ei),
        edge_j=jnp.asarray(ej),
        edge_r=jnp.asarray(er),
        edge_t=jnp.asarray(et),
        edge_valid=jnp.ones(len(all_edges), bool),
        edge_weight=jnp.asarray(weights),
    )
    imu_incs = None
    if imu is not None:
        imu_t, imu_gyro, imu_accel = imu
        node_times = frame_times[np.asarray(nodes)]
        imu_incs = imu_mod.preintegrate_segments(
            imu_t, imu_gyro, imu_accel, node_times
        )
        # Empty segments mean NO IMU coverage there, not "no motion":
        # an identity increment fed to the graph would be a weight-2
        # zero-rotation edge actively bending a rotating trajectory.
        # Drop those edges, and reject outright when nothing overlaps
        # (the classic epoch-vs-boot clock time-base mismatch).
        covered = [
            (i, inc) for i, inc in enumerate(imu_incs) if inc.n_samples > 0
        ]
        if not covered:
            raise ValueError(
                "no IMU samples overlap the frame window "
                f"[{node_times[0]:.3f}, {node_times[-1]:.3f}] s "
                f"(IMU spans [{imu_t[0]:.3f}, {imu_t[-1]:.3f}] s) — "
                "check that frame_times and the IMU stream share a time "
                "base"
            )
        if len(covered) < len(imu_incs):
            print(
                f"WARNING: {len(imu_incs) - len(covered)} of "
                f"{len(imu_incs)} keyframe intervals have no IMU "
                "samples; skipping their gyro edges"
            )
        g = imu_mod.gyro_rotation_edges(
            g, [inc for _i, inc in covered],
            [(i, i + 1) for i, _inc in covered],
            weight=imu_weight, r_cam_imu=imu_r_cam,
        )
    if motion_prior_weight > 0.0:
        # Soft constant-velocity prior anchored to the odometry-chained
        # initialization (pose_graph.constant_velocity_edges docstring).
        g = pose_graph.constant_velocity_edges(g, motion_prior_weight)
    solved = pose_graph.solve(g, iterations=pg_iterations)
    resid = float(
        jnp.abs(pose_graph.residuals(solved)).max()
    )
    # Visual-inertial alignment: with accelerometer content, the solved
    # (up-to-scale) trajectory + gravity-free increments determine the
    # metric scale. Accept only when the recovered gravity magnitude is
    # physical (degenerate motion — e.g. constant velocity — makes the
    # system ill-conditioned and g drifts away from 9.81).
    metric_scale = None
    metric_poses = False
    out_r = np.asarray(solved.poses_r)
    out_t = np.asarray(solved.poses_t)
    if (
        imu_incs is not None
        and len(nodes) >= 4
        and all(inc.n_samples > 0 for inc in imu_incs)
    ):
        try:
            s_hat, g_hat, _v, _rms = imu_mod.estimate_scale_and_gravity(
                out_r, out_t, imu_incs, r_cam_imu=imu_r_cam,
            )
            if 8.0 < float(np.linalg.norm(g_hat)) < 12.0 and s_hat > 0:
                metric_scale = s_hat
                if imu_tight:
                    from tpuflow.vo import vi_graph

                    sol = vi_graph.solve_vi(
                        out_r, out_t, imu_incs, g_hat,
                        r_cam_imu=imu_r_cam,
                        init_scale=s_hat, init_velocities=_v,
                    )
                    # Guard the adoption: jnp.linalg.solve returns
                    # garbage (not an exception) on a near-singular
                    # f32 system — never let NaN poses replace a good
                    # visual trajectory and be reported as METRIC.
                    finite = (
                        np.isfinite(sol.poses_r).all()
                        and np.isfinite(sol.poses_t).all()
                        and np.isfinite(sol.residual_rms)
                        and sol.scale > 0
                    )
                    if finite:
                        out_r, out_t = sol.poses_r, sol.poses_t
                        metric_scale = sol.scale
                        metric_poses = True
        except np.linalg.LinAlgError:
            pass
    return OdometryResult(
        poses_r=out_r,
        poses_t=out_t,
        landmarks=last_result.landmarks,
        keyframe_indices=nodes,
        track_count=last_result.track_count,
        mean_reprojection_error=resid,
        track_loss_frames=sorted(loss_frames),
        metric_scale=metric_scale,
        metric_poses=metric_poses,
    )
