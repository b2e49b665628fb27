"""VO trajectory verification: synthetic sequences with analytic pose
ground truth, ATE/RPE scoring, and a committed-baseline regression gate.

The trajectory-side twin of tpuflow.eval.verifier: the flow suite gates
per-pattern MAE/EPE against a committed baseline with a 10% threshold
(reference mechanism: python/optical_flow_verifier.py:586-634); this
gates per-sequence ATE-RMSE / RPE the same way, so back-end changes
(tracking, BA, pose graph) are regression-checked in CI like kernel
changes are.

Ground truth is exact: each sequence renders a textured fronto-parallel
plane (depth ``PLANE_DEPTH``) under a known SE(3) camera trajectory via
the planar homography ``H_{0->i} = K (R_i + t_i n^T / d) K^{-1}``
(world frame = camera-0 frame, plane normal n = e_z), inverse-warped
with bilinear sampling — no approximation between the pose ground truth
and the pixels.

CLI:
    python -m tpuflow.eval.vo_verifier --compare-baseline
    python -m tpuflow.eval.vo_verifier --update-baseline
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpuflow.eval import patterns as patterns_mod
from tpuflow.eval.vo_metrics import trajectory_metrics
from tpuflow.flow.backend import BACKENDS, is_clamped

VO_BASELINE = Path(__file__).parent / "data" / "vo_baseline.json"

WIDTH, HEIGHT = 320, 240
FX = FY = 300.0
PLANE_DEPTH = 5.0
N_FRAMES = 8
GATED_METRICS = ("ate_rmse", "rpe_trans", "rpe_rot_deg")


def _yaw(angle_rad: float) -> np.ndarray:
    """Rotation about the camera y axis (pan)."""
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _pose_from_center(r_wc: np.ndarray, center: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """world->camera (R, t) for a camera at ``center`` with cam->world
    rotation ``r_wc``: R = r_wc^T, t = -R c."""
    r = r_wc.T
    return r, -(r @ np.asarray(center, np.float64))


# ---------------------------------------------------------------------------
# Sequence definitions — each returns (K, 3, 3) / (K, 3) world->camera
# ground-truth poses. Motions sized for ~1-2 px/frame image flow at
# fx=300, depth=5 (LK's comfortable regime; larger steps belong to the
# flow suite's translate_large-style stress patterns, not the VO ruler).
# ---------------------------------------------------------------------------


def _poses_strafe(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pure lateral translation: +0.02 world units/frame along x
    (1.2 px/frame image shift)."""
    rs, ts = [], []
    for i in range(n):
        r, t = _pose_from_center(np.eye(3), [0.02 * i, 0.0, 0.0])
        rs.append(r)
        ts.append(t)
    return np.stack(rs), np.stack(ts)


def _poses_dolly(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Forward translation toward the plane: +0.02/frame along z
    (zoom-like radial flow, <=0.9 px/frame at the frame corners)."""
    rs, ts = [], []
    for i in range(n):
        r, t = _pose_from_center(np.eye(3), [0.0, 0.0, 0.02 * i])
        rs.append(r)
        ts.append(t)
    return np.stack(rs), np.stack(ts)


def _poses_arc(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Combined motion: lateral translation + 0.15 deg/frame yaw
    (translation-plus-rotation, the hardest class for a planar scene)."""
    rs, ts = [], []
    for i in range(n):
        r, t = _pose_from_center(
            _yaw(np.radians(0.15) * i), [0.015 * i, 0.0, 0.0]
        )
        rs.append(r)
        ts.append(t)
    return np.stack(rs), np.stack(ts)


def _poses_square(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Closed square loop over the plane: 4 sides of n//4 steps each,
    returning to the start — exercises the chunked pose-graph pipeline
    with loop closure (the final frames revisit the first pose)."""
    side = max((n - 1) // 4, 1)  # 4*side + 1 poses (close the loop)
    step = 0.018
    c = np.zeros(3)
    centers = [c.copy()]
    for d in ([step, 0, 0], [0, step, 0], [-step, 0, 0], [0, -step, 0]):
        for _ in range(side):
            c = c + np.asarray(d, np.float64)
            centers.append(c.copy())
    rs, ts = [], []
    for center in centers:
        r, t = _pose_from_center(np.eye(3), center)
        rs.append(r)
        ts.append(t)
    return np.stack(rs), np.stack(ts)


# Accelerating sequence for the visual-inertial stack: steady lateral
# drift + sinusoidal swing. The swing provides the acceleration content
# scale/gravity need (constant velocity is unobservable to an
# accelerometer); the drift keeps velocity strictly positive — PURE
# oscillation is a measured vision-BA degeneracy (the oscillating
# planar scene admits a wrong-shape solution at ~0.55 px reprojection,
# so there is no valid vision trajectory for the IMU to refine).
# Closed forms shared by the pose generator and the IMU synthesizer.
SWING_AMP, SWING_HZ, SWING_DRIFT, SWING_FRAME_RATE = 0.03, 0.5, 0.1, 4.0
GRAVITY_W = np.array([0.0, 0.0, -9.81])


def _swing_x(t: np.ndarray):
    om = 2 * np.pi * SWING_HZ
    return SWING_DRIFT * t + SWING_AMP * np.sin(om * t)


def _poses_swing(n: int) -> Tuple[np.ndarray, np.ndarray]:
    rs, ts = [], []
    for i in range(n):
        t = i / SWING_FRAME_RATE
        r, t_ = _pose_from_center(np.eye(3), [_swing_x(t), 0.0, 0.0])
        rs.append(r)
        ts.append(t_)
    return np.stack(rs), np.stack(ts)


def _imu_swing(n: int, rate_hz: float = 200.0):
    """Exact IMU for the swing trajectory: zero gyro, specific force
    f = a_world - g in the (world-aligned) body frame."""
    om = 2 * np.pi * SWING_HZ
    t_end = (n - 1) / SWING_FRAME_RATE
    m = int(t_end * rate_hz) + 1
    ts = np.arange(m) / rate_hz
    ax = -SWING_AMP * om * om * np.sin(om * ts)
    accel = np.stack(
        [ax, np.zeros(m), np.full(m, -GRAVITY_W[2])], 1
    ).astype(np.float32)
    gyro = np.zeros((m, 3), np.float32)
    frame_times = np.arange(n) / SWING_FRAME_RATE
    return ts, gyro, accel, frame_times


SEQUENCES = {
    "strafe_x": _poses_strafe,
    "dolly_z": _poses_dolly,
    "arc_yaw": _poses_arc,
    "square_loop": _poses_square,
    "swing_imu": _poses_swing,
}

# Per-sequence pipeline mode: the square loop runs the chunked
# local-BA + pose-graph pipeline WITH loop closure (the revisit at the
# end is the point); swing_imu runs chunked with exact synthetic IMU
# and the tightly-coupled VI refinement, scored METRIC (SE(3)-only
# alignment — a scale error shows up in ATE). swing_imu's absolute ATE
# is vision-limited, not IMU-limited: the fronto-planar scene distorts
# the monocular BA's trajectory shape (reseeded landmark cohorts
# reconcile scale imperfectly), and VI refinement cannot out-vote a
# wrong vision shape everywhere — the same VI machinery recovers 0.985
# of the metric span on a well-behaved vision trajectory
# (tests/test_vo_imu.py::test_chunked_imu_tight_recovers_metric_span).
# The gate still regression-pins the ENTIRE VI code path (preintegrate
# -> chunk metric anchoring -> gyro edges -> tight refinement) end to
# end. The rest run the incremental session.
SEQUENCE_MODES = {
    "square_loop": "chunked_loop",
    "swing_imu": "chunked_imu_tight",
}
# Fixed lengths where the geometry dictates one (a square needs 4 full
# sides; the swing needs full acceleration periods); --frames applies
# to the rest.
SEQUENCE_LENGTHS = {"square_loop": 17, "swing_imu": 16}


def intrinsics() -> Tuple[float, float, float, float]:
    return (FX, FY, WIDTH / 2.0, HEIGHT / 2.0)


def render_sequence(
    poses_r: np.ndarray,
    poses_t: np.ndarray,
    width: int = WIDTH,
    height: int = HEIGHT,
    depth: float = PLANE_DEPTH,
    base: Optional[np.ndarray] = None,
    k: Optional[Tuple[float, float, float, float]] = None,
) -> List[np.ndarray]:
    """Render each camera's view of the textured plane Z = ``depth``.

    ``base`` is camera 0's (height, width) view of the plane (default:
    the texture asset resized); ``k`` the intrinsics (fx, fy, cx, cy)
    (default: :func:`intrinsics`).

    Frame i is the base texture inverse-warped by H_{0->i}^{-1}: a pixel
    x_i in camera i images the plane point that camera 0 sees at
    x_0 ~ H^{-1} x_i, H = K (R_i + t_i n^T / d) K^{-1}. Bilinear
    sampling, edge-replicated out-of-frame (matching the VO tests'
    convention so border tracks stay textured).
    """
    from scipy.ndimage import map_coordinates

    if base is None:
        base = patterns_mod.load_base_texture(width, height)
    base = np.asarray(base, np.float32)
    fx, fy, cx, cy = k or intrinsics()
    k_mat = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    k_inv = np.linalg.inv(k_mat)
    n_vec = np.array([0.0, 0.0, 1.0])

    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    pix_h = np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1)

    frames = []
    for r, t in zip(poses_r, poses_t):
        h_mat = k_mat @ (np.asarray(r, np.float64) + np.outer(np.asarray(t, np.float64), n_vec) / depth) @ k_inv
        src = np.linalg.inv(h_mat) @ pix_h
        src = src[:2] / src[2:3]
        frame = map_coordinates(
            base,
            [src[1].reshape(height, width), src[0].reshape(height, width)],
            order=1,
            mode="nearest",
        )
        frames.append(frame.astype(np.float32))
    return frames


# ---------------------------------------------------------------------------
# Verification + baseline regression
# ---------------------------------------------------------------------------


def verify_sequence(
    name: str,
    n_frames: int = N_FRAMES,
    backend: str = "jnp",
    ba_iterations: int = 10,
    verbose: bool = True,
    pyramid_config: str = "default",
) -> Dict[str, Any]:
    """Render one sequence, run the full VO pipeline, score ATE/RPE."""
    from tpuflow.vo.pipeline import run_odometry, run_odometry_chunked

    n_frames = SEQUENCE_LENGTHS.get(name, n_frames)
    gt_r, gt_t = SEQUENCES[name](n_frames)
    frames = render_sequence(gt_r, gt_t)
    n_frames = len(frames)  # report what was actually rendered
    mode = SEQUENCE_MODES.get(name)
    if mode == "chunked_loop":
        result = run_odometry_chunked(
            frames,
            intrinsics(),
            chunk_size=6,
            init_depth=PLANE_DEPTH,
            ba_iterations=ba_iterations,
            backend=backend,
            loop_closure=True,
            pyramid_config=pyramid_config,
        )
    elif mode == "chunked_imu_tight":
        imu_t, imu_gyro, imu_accel, frame_times = _imu_swing(n_frames)
        result = run_odometry_chunked(
            frames,
            intrinsics(),
            chunk_size=6,
            init_depth=PLANE_DEPTH,
            ba_iterations=ba_iterations,
            backend=backend,
            imu=(imu_t, imu_gyro, imu_accel),
            frame_times=frame_times,
            imu_tight=True,
            pyramid_config=pyramid_config,
        )
    else:
        result = run_odometry(
            frames,
            intrinsics(),
            init_depth=PLANE_DEPTH,
            ba_iterations=ba_iterations,
            backend=backend,
            pyramid_config=pyramid_config,
        )
    # Keyframe stride is 1 here, so keyframe poses line up 1:1 with the
    # ground-truth frames.
    kf = result.keyframe_indices
    # Metric (VI-refined) trajectories are scored with SE(3)-only
    # alignment — the recovered scale is part of what's being graded.
    metrics = trajectory_metrics(
        result.poses_r, result.poses_t, gt_r[kf], gt_t[kf],
        with_scale=not result.metric_poses,
    )
    metrics["mean_reprojection_error"] = float(result.mean_reprojection_error)
    metrics["metric_poses"] = bool(result.metric_poses)
    if verbose:
        print(
            f"{name:12s} ate_rmse={metrics['ate_rmse']:.5f} "
            f"rpe_trans={metrics['rpe_trans']:.5f} "
            f"rpe_rot={metrics['rpe_rot_deg']:.4f}deg "
            f"scale={metrics['scale']:.3f} "
            f"reproj={metrics['mean_reprojection_error']:.3f}px "
            f"tracks={result.track_count}"
        )
    return {
        "sequence": name,
        "n_frames": n_frames,
        "metrics": metrics,
        "track_count": int(result.track_count),
    }


def run_suite(
    sequence_names: Optional[List[str]] = None,
    backend: str = "jnp",
    verbose: bool = True,
    n_frames: int = N_FRAMES,
    ba_iterations: int = 10,
    pyramid_config: str = "default",
) -> List[Dict[str, Any]]:
    names = sequence_names or list(SEQUENCES)
    unknown = [n for n in names if n not in SEQUENCES]
    if unknown:
        raise SystemExit(
            f"Unknown sequence(s): {', '.join(unknown)}. "
            f"Available: {', '.join(SEQUENCES)}"
        )
    return [
        verify_sequence(
            n, n_frames=n_frames, backend=backend,
            ba_iterations=ba_iterations, verbose=verbose,
            pyramid_config=pyramid_config,
        )
        for n in names
    ]


# Cross-host reproducibility limit of the CPU (jnp) trajectory suite.
# Unlike the flow gate — which compares SciPy-parity convolutions that
# reproduce bit-identically everywhere — the VO suite runs fixed-point
# Gauss-Newton on top of a convergence-gated flow loop, and XLA:CPU
# codegen differences between host CPU generations (FMA contraction /
# vectorization choices) perturb the iteration path chaotically.
# Measured on two different x86 hosts (2026-08, same jaxlib, same
# commit): per-metric spreads up to +-50% RELATIVE while every absolute
# trajectory score stayed excellent (ate_rmse 0.002-0.013 on >=0.1-span
# sequences both times, most metrics IMPROVING host-to-host). A 10%
# relative gate is therefore unenforceable on CPU; the CPU gate uses
# this threshold as a breakage detector and ABS_BOUNDS as the primary
# accuracy ruler (check_absolute_bounds, enforced on every
# --compare-baseline run).
CPU_CROSS_HOST_THRESHOLD = 60.0

# Absolute trajectory-accuracy bounds: the host-stable primary gate.
# Every sequence spans >= ~0.1 world units, so ATE-RMSE must stay well
# under that for the pipeline to be "working" in any meaningful sense;
# these bounds hold with huge margin on every platform measured while
# the relative gate wobbles with codegen. square_loop carries more interior
# drift than the straight sequences (chunk-fused trajectory); swing_imu
# is scored METRIC (no scale gauge to absorb error) and its absolute
# ATE is vision-limited on the planar scene (see SEQUENCE_MODES note).
ABS_ATE_BOUNDS = {"square_loop": 0.05, "swing_imu": 0.12}
ABS_ATE_DEFAULT = 0.03
ABS_RPE_ROT_DEG = 1.0
MIN_TRACK_COUNT = 100

# Cross-PLATFORM (CPU baseline vs accelerator run, or vice versa)
# relative threshold. The GN/BA/VI matmuls are pinned to HIGHEST
# precision (vo/_precision.py); without the pinning an accelerator's
# reduced-precision matmuls made trajectories diverge without bound.
# The CHUNKED sequences (square_loop, swing_imu) still spread widely
# in relative terms: the dense-flow front end itself differs across
# platforms at the sub-percent level (within its own 10% parity gate)
# and the chunk anchoring composition amplifies it — chaotically, like
# the cross-host CPU spread, while absolute scores stay excellent.
CROSS_PLATFORM_THRESHOLD = 60.0

# Per-metric absolute floors for cross-provenance (cross-host or
# cross-platform) comparison: a change only flags if it exceeds the
# floor absolutely AND the threshold relatively. Sized at ~1/4 of the
# ABS bounds' health margins (trajectory spans are >= ~0.1 world
# units; rot health bound is 1 deg): the measured example that
# motivates the rot floor is a swing_imu rpe_rot move of 0.035 to 0.197
# deg between platforms, +463% relative on an absolutely-negligible
# 0.16 deg move of a VI-refined rotation. Same-provenance comparison
# keeps the tight 1e-4 dust floor.
CROSS_METRIC_FLOORS = {
    "ate_rmse": 0.005,
    "rpe_trans": 0.005,
    "rpe_rot_deg": 0.25,
}


def default_threshold(
    platform: str, baseline_path: Path = VO_BASELINE
) -> tuple[float, dict | float]:
    """(threshold, abs_floor) for (actual platform, baseline).

    - Same platform as the baseline: CPU_CROSS_HOST_THRESHOLD
      (host-to-host codegen spread; see its note) with the
      cross-provenance metric floors.
    - DIFFERENT platform than the baseline: CROSS_PLATFORM_THRESHOLD +
      metric floors, with absolute bounds doing the real gating either
      way.
    """
    base_platform = None
    if baseline_path.exists():
        try:
            base_platform = json.loads(baseline_path.read_text()).get(
                "platform"
            )
        except (OSError, json.JSONDecodeError):
            pass
    if base_platform is not None and base_platform != platform:
        return CROSS_PLATFORM_THRESHOLD, CROSS_METRIC_FLOORS
    return CPU_CROSS_HOST_THRESHOLD, CROSS_METRIC_FLOORS


def check_absolute_bounds(
    results: List[Dict[str, Any]], verbose: bool = True
) -> bool:
    """Primary accuracy gate: host/platform-independent absolute bounds.

    Relative baseline comparison (below) detects *drift*; this detects
    *breakage* — and unlike the relative gate it is enforceable on any
    platform without a matching-provenance baseline.
    """
    ok = True
    for r in results:
        name = r["sequence"]
        m = r["metrics"]
        bound = ABS_ATE_BOUNDS.get(name, ABS_ATE_DEFAULT)
        if not m["ate_rmse"] < bound:
            ok = False
            print(
                f"  ABSOLUTE BOUND {name}: ate_rmse {m['ate_rmse']:.5f} "
                f">= {bound}"
            )
        if not m["rpe_rot_deg"] < ABS_RPE_ROT_DEG:
            ok = False
            print(
                f"  ABSOLUTE BOUND {name}: rpe_rot {m['rpe_rot_deg']:.4f} "
                f">= {ABS_RPE_ROT_DEG} deg"
            )
        if not r["track_count"] > MIN_TRACK_COUNT:
            ok = False
            print(
                f"  ABSOLUTE BOUND {name}: track_count {r['track_count']} "
                f"<= {MIN_TRACK_COUNT}"
            )
    if verbose:
        print(
            "VO absolute-bounds check: "
            + ("all sequences within bounds" if ok else "FAILURES detected")
        )
    return ok


def compare_against_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path = VO_BASELINE,
    threshold_percent: float = 10.0,
    abs_floor: float | Dict[str, float] = 1e-4,
    verbose: bool = True,
    backend: str | None = None,
    pyramid_config: str | None = None,
    platform: str | None = None,
) -> bool:
    """True = no regressions. Same 10% rule as the flow verifier, with an
    absolute floor: a metric change only flags if it ALSO exceeds
    ``abs_floor`` in absolute terms, so near-zero baselines (e.g.
    rpe_rot on a pure-translation sequence) don't gate on numerical
    dust the way the flow suite's exact-zero no_motion rows can.

    On the jnp backend across DIFFERENT host CPUs, pass
    ``threshold_percent=CPU_CROSS_HOST_THRESHOLD`` (see its note).

    ``platform``: the ACTUAL execution platform of this run
    (``jax.default_backend()``), checked against the platform recorded
    in the baseline. The jnp backend runs on whatever platform JAX
    picked — on an accelerator host that is the accelerator, whose f32
    numerics differ from the CPU's — so the flag-level backend check
    alone cannot catch cross-provenance comparison."""
    if not baseline_path.exists():
        print(f"No VO baseline at {baseline_path}; skipping regression check.")
        return True
    doc = json.loads(baseline_path.read_text())
    base_backend = doc.get("backend")
    # The fast backends (xla, pallas) share one semantics.
    if (
        backend is not None
        and base_backend is not None
        and is_clamped(backend) != is_clamped(base_backend)
    ):
        print(
            f"PROVENANCE MISMATCH: VO baseline captured with backend="
            f"{base_backend!r} but this run uses backend={backend!r}."
        )
        return False
    base_platform = doc.get("platform")
    if (
        platform is not None
        and base_platform is not None
        and platform != base_platform
    ):
        print(
            f"PROVENANCE NOTE: VO baseline captured on platform="
            f"{base_platform!r}; this run executes on {platform!r}. "
            f"Relative comparison is cross-platform (see "
            f"CROSS_PLATFORM_THRESHOLD); absolute bounds are the "
            f"primary gate."
        )
    # Same guard for the front-end flow config (a baseline captured with
    # the default band must not silently gate a narrow-band run). An
    # absent key means the baseline predates the knob — captured with
    # "default".
    base_cfg = doc.get("pyramid_config", "default")
    if pyramid_config is not None and pyramid_config != base_cfg:
        print(
            f"PROVENANCE MISMATCH: VO baseline captured with "
            f"pyramid_config={base_cfg!r} but this run uses "
            f"pyramid_config={pyramid_config!r}."
        )
        return False
    baseline = doc.get("sequences", {})
    all_passed = True
    for result in results:
        name = result["sequence"]
        if name not in baseline:
            if verbose:
                print(f"  {name}: not in baseline (skipping)")
            continue
        # The scoring REGIME is gated too: losing metric_poses switches
        # swing_imu to Sim(3) alignment, whose gauge absorbs exactly the
        # scale error the metric score exists to check — a silent
        # fallback would otherwise stay within the 10% metric window.
        base_mp = baseline[name]["metrics"].get("metric_poses")
        curr_mp = result["metrics"].get("metric_poses")
        if base_mp is not None and curr_mp is not None and base_mp != curr_mp:
            all_passed = False
            print(
                f"  REGRESSION {name}: metric_poses changed "
                f"{base_mp} -> {curr_mp} (scoring regime switch)"
            )
            continue
        for metric in GATED_METRICS:
            curr = result["metrics"][metric]
            base = baseline[name]["metrics"][metric]
            floor = (
                abs_floor.get(metric, 1e-4)
                if isinstance(abs_floor, dict)
                else abs_floor
            )
            if abs(curr - base) <= floor:
                continue
            if base <= floor:
                all_passed = False
                print(f"  REGRESSION {name}: {metric} {curr:.5f} (baseline ~0)")
                continue
            change = 100.0 * (curr - base) / base
            if abs(change) > threshold_percent:
                all_passed = False
                print(
                    f"  REGRESSION {name}: {metric} {change:+.1f}% "
                    f"(current={curr:.5f}, baseline={base:.5f})"
                )
    if verbose:
        print(
            "VO regression check: "
            + ("all sequences within threshold" if all_passed else "FAILURES detected")
        )
    return all_passed


def update_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path = VO_BASELINE,
    backend: str | None = None,
    pyramid_config: str | None = None,
    platform: str | None = None,
) -> None:
    data: Dict[str, Any] = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "sequences": {r["sequence"]: r for r in results},
    }
    if backend is not None:
        data["backend"] = backend
    if pyramid_config is not None:
        data["pyramid_config"] = pyramid_config
    if platform is not None:
        data["platform"] = platform
    baseline_path.parent.mkdir(parents=True, exist_ok=True)
    baseline_path.write_text(json.dumps(data, indent=2))
    print(f"VO baseline updated: {baseline_path}")


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Verify VO trajectory accuracy (ATE/RPE) on synthetic "
        "sequences with analytic pose ground truth"
    )
    parser.add_argument("--sequence", type=str, nargs="+", default=None)
    parser.add_argument("--backend", type=str, default="jnp", choices=BACKENDS)
    parser.add_argument("--frames", type=int, default=N_FRAMES)
    parser.add_argument("--ba-iterations", type=int, default=10)
    parser.add_argument("--compare-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument(
        "--regression-threshold", type=float, default=None,
        help="percent gate vs the committed baseline; default "
        "CPU_CROSS_HOST_THRESHOLD with per-metric absolute floors "
        "(codegen varies by host CPU and platform — see "
        "default_threshold). Absolute accuracy bounds "
        "(check_absolute_bounds) are enforced regardless.",
    )
    parser.add_argument("--baseline", type=str, default=str(VO_BASELINE))
    parser.add_argument(
        "--pyramid-config", type=str, default="default",
        help="named flow config for the VO front-end (e.g. production); "
        "recorded in / checked against the baseline's provenance",
    )
    args = parser.parse_args()

    import jax  # deferred: platform resolution must not precede CLI parse

    platform = jax.default_backend()

    results = run_suite(
        args.sequence, backend=args.backend, n_frames=args.frames,
        ba_iterations=args.ba_iterations, pyramid_config=args.pyramid_config,
    )

    if args.update_baseline:
        update_baseline(
            results, Path(args.baseline), backend=args.backend,
            pyramid_config=args.pyramid_config, platform=platform,
        )
    if args.compare_baseline:
        # Primary gate: platform-independent absolute accuracy bounds.
        bounds_ok = check_absolute_bounds(results)
        threshold = args.regression_threshold
        if threshold is None:
            threshold, floor = default_threshold(platform, Path(args.baseline))
        else:
            floor = 1e-4
        ok = compare_against_baseline(
            results, Path(args.baseline), threshold, abs_floor=floor,
            backend=args.backend, pyramid_config=args.pyramid_config,
            platform=platform,
        )
        if not (ok and bounds_ok):
            print("\nVO regression detected! Review changes before committing.")
            sys.exit(1)


if __name__ == "__main__":
    main()
