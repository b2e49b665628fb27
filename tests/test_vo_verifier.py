"""Trajectory-metric (ATE/RPE) harness tests: Umeyama alignment, metric
definitions, the homography sequence renderer, and the committed-baseline
regression gate (the VO twin of tests/test_verifier_regression.py)."""

import json

import numpy as np
import pytest

from tpuflow.eval import vo_metrics, vo_verifier


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _random_rotation(rng):
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    return q


# ---------------------------------------------------------------------------
# vo_metrics
# ---------------------------------------------------------------------------


def test_umeyama_recovers_known_similarity(rng):
    src = rng.normal(size=(20, 3))
    r_true = _random_rotation(rng)
    s_true, t_true = 2.3, np.array([0.5, -1.0, 3.0])
    dst = s_true * src @ r_true.T + t_true
    s, r, t = vo_metrics.umeyama_alignment(src, dst)
    assert abs(s - s_true) < 1e-9
    np.testing.assert_allclose(r, r_true, atol=1e-9)
    np.testing.assert_allclose(t, t_true, atol=1e-9)


def test_umeyama_no_scale(rng):
    src = rng.normal(size=(10, 3))
    dst = 3.0 * src  # pure scale change
    s, _, _ = vo_metrics.umeyama_alignment(src, dst, with_scale=False)
    assert s == 1.0


def test_ate_zero_for_gauge_transformed_trajectory(rng):
    """ATE must be invariant to the monocular gauge: a scaled+rotated+
    translated copy of the ground truth scores exactly zero."""
    k = 8
    gt_r = np.stack([_random_rotation(rng) for _ in range(k)])
    centers = np.cumsum(rng.normal(scale=0.1, size=(k, 3)), axis=0)
    gt_t = np.einsum("kij,kj->ki", gt_r, -centers)

    g_r = _random_rotation(rng)
    g_s, g_t = 1.7, np.array([1.0, 2.0, 3.0])
    est_centers = g_s * centers @ g_r.T + g_t
    est_r = np.einsum("kij,jl->kil", gt_r, g_r.T)  # R_i' = R_i g_R^T
    est_t = np.einsum("kij,kj->ki", est_r, -est_centers)

    ate, scale = vo_metrics.ate_rmse(est_r, est_t, gt_r, gt_t)
    assert ate < 1e-9
    assert abs(scale - 1.0 / g_s) < 1e-9
    rpe_t, rpe_r = vo_metrics.rpe(est_r, est_t, gt_r, gt_t)
    # rpe_r tolerance is loose: arccos of a trace within f64 eps of 3
    # amplifies to ~1e-7 deg of angle noise.
    assert rpe_t < 1e-9 and rpe_r < 1e-5


def test_rpe_detects_kink(rng):
    """A single corrupted pose shows up in RPE (and ATE)."""
    k = 8
    gt_r = np.tile(np.eye(3), (k, 1, 1))
    centers = np.stack([np.arange(k) * 0.1, np.zeros(k), np.zeros(k)], axis=1)
    gt_t = -centers
    est_t = gt_t.copy()
    est_t[4, 1] += 0.3  # kink
    rpe_t, _ = vo_metrics.rpe(gt_r, est_t, gt_r, gt_t, scale=1.0)
    assert rpe_t > 0.05
    ate, _ = vo_metrics.ate_rmse(gt_r, est_t, gt_r, gt_t)
    assert ate > 0.01


def test_rpe_rotation_error_degrees():
    k = 5
    gt_r = np.tile(np.eye(3), (k, 1, 1))
    gt_t = np.zeros((k, 3))
    gt_t[:, 0] = -np.arange(k) * 0.1  # nonzero baseline for alignment
    # Estimated: constant 1-degree-per-step yaw drift.
    est_r = np.stack(
        [vo_verifier._yaw(np.radians(1.0) * i).T for i in range(k)]
    )
    est_t = gt_t.copy()
    _, rpe_rot = vo_metrics.rpe(est_r, est_t, gt_r, gt_t, scale=1.0)
    assert abs(rpe_rot - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# Sequence renderer
# ---------------------------------------------------------------------------


def test_strafe_render_matches_plain_shift():
    """For pure lateral motion the planar homography degenerates to a
    uniform image shift of fx*tx/Z px — the renderer must agree with
    scipy.ndimage.shift to interpolation accuracy."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns

    gt_r, gt_t = vo_verifier._poses_strafe(3)
    frames = vo_verifier.render_sequence(gt_r, gt_t)
    base = patterns.load_base_texture(
        vo_verifier.WIDTH, vo_verifier.HEIGHT
    ).astype(np.float32)
    px = vo_verifier.FX * 0.02 / vo_verifier.PLANE_DEPTH  # 1.2 px/frame
    for i, frame in enumerate(frames):
        expected = nd_shift(base, (0.0, -px * i), order=1, mode="nearest")
        np.testing.assert_allclose(frame, expected, atol=1e-3)


def test_dolly_render_zooms_in():
    """Moving toward the plane magnifies: center crop variance of detail
    spreads — check the known analytic correspondence at one off-center
    pixel instead of an image-statistics heuristic."""
    gt_r, gt_t = vo_verifier._poses_dolly(2)
    frames = vo_verifier.render_sequence(gt_r, gt_t)
    fx, fy, cx, cy = vo_verifier.intrinsics()
    # Plane point imaged at pixel (cx+50, cy) by cam0 sits at
    # X = 50*Z/fx; cam1 at z=+0.02 sees it at x' = fx*X/(Z-0.02).
    x_world = 50.0 * vo_verifier.PLANE_DEPTH / fx
    x1 = fx * x_world / (vo_verifier.PLANE_DEPTH - 0.02)
    # frame1 at pixel (cx + x1) must equal frame0 at (cx + 50).
    from scipy.ndimage import map_coordinates

    v0 = frames[0][int(cy), int(cx) + 50]
    v1 = map_coordinates(
        frames[1], [[cy], [cx + x1]], order=1, mode="nearest"
    )[0]
    assert abs(v0 - v1) < 2.0  # bilinear resample tolerance (u8 texture)


# ---------------------------------------------------------------------------
# End-to-end gate (the committed-baseline regression mechanism)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_vo_suite_within_committed_baseline():
    """The full VO trajectory gate, as CI runs it: all sequences within
    the cross-host threshold of tpuflow/eval/data/vo_baseline.json.

    The threshold is CPU_CROSS_HOST_THRESHOLD, not the flow suite's 10%:
    the CPU trajectory numbers move up to ~50% between host CPU
    generations (XLA:CPU codegen; see the constant's note) while staying
    absolutely excellent. The absolute bounds below are the host-stable
    accuracy ruler for the CPU run."""
    results = vo_verifier.run_suite(verbose=False)
    assert vo_verifier.compare_against_baseline(
        results,
        threshold_percent=vo_verifier.CPU_CROSS_HOST_THRESHOLD,
        abs_floor=vo_verifier.CROSS_METRIC_FLOORS,
        backend="jnp",
    )
    # The primary gate: platform-independent absolute accuracy bounds
    # (ABS_ATE_BOUNDS / ABS_RPE_ROT_DEG / MIN_TRACK_COUNT — see their
    # notes in vo_verifier; the relative gate above only detects drift).
    assert vo_verifier.check_absolute_bounds(results)
    for r in results:
        if r["sequence"] == "swing_imu":
            # The VI refinement must actually run on the jnp path — a
            # silent fallback to loose Sim(3) scoring would absorb the
            # very scale error the metric gate exists to catch.
            assert r["metrics"]["metric_poses"] is True, r


def test_baseline_provenance_and_regression_flag(tmp_path):
    """Backend mismatch fails outright; a >10% metric drift flags."""
    results = [
        {
            "sequence": "strafe_x",
            "n_frames": 8,
            "metrics": {
                "ate_rmse": 0.010, "rpe_trans": 0.010, "rpe_rot_deg": 0.10,
                "scale": 1.0, "mean_reprojection_error": 0.3,
            },
            "track_count": 300,
        }
    ]
    path = tmp_path / "base.json"
    vo_verifier.update_baseline(results, path, backend="jnp")
    assert vo_verifier.compare_against_baseline(results, path, backend="jnp")
    assert not vo_verifier.compare_against_baseline(
        results, path, backend="pallas"
    )
    worse = json.loads(json.dumps(results))
    worse[0]["metrics"]["ate_rmse"] = 0.012  # +20%
    assert not vo_verifier.compare_against_baseline(worse, path, backend="jnp")
    # Sub-floor absolute changes never flag even at huge relative change.
    tiny = json.loads(json.dumps(results))
    tiny[0]["metrics"]["rpe_rot_deg"] = 0.10005
    assert vo_verifier.compare_against_baseline(tiny, path, backend="jnp")


def test_platform_provenance_and_cross_floors(tmp_path):
    """Round-4 gate mechanics: platform recorded in the baseline, the
    cross-provenance metric floors absorb absolutely-negligible moves
    (the measured swing_imu rpe_rot 0.035->0.197 deg case), and
    default_threshold picks (threshold, floor) per provenance."""
    results = [
        {
            "sequence": "swing_imu",
            "n_frames": 16,
            "metrics": {
                "ate_rmse": 0.070, "rpe_trans": 0.0154,
                "rpe_rot_deg": 0.035, "scale": 1.0,
                "mean_reprojection_error": 0.01, "metric_poses": True,
            },
            "track_count": 293,
        }
    ]
    path = tmp_path / "base.json"
    vo_verifier.update_baseline(
        results, path, backend="jnp", platform="cpu"
    )
    assert json.loads(path.read_text())["platform"] == "cpu"

    # A +463% relative rot move that is absolutely tiny: flags with the
    # dust floor, passes with the cross-provenance floors.
    moved = json.loads(json.dumps(results))
    moved[0]["metrics"]["rpe_rot_deg"] = 0.197
    assert not vo_verifier.compare_against_baseline(
        moved, path, threshold_percent=60.0, abs_floor=1e-4, backend="jnp"
    )
    assert vo_verifier.compare_against_baseline(
        moved, path, threshold_percent=60.0,
        abs_floor=vo_verifier.CROSS_METRIC_FLOORS, backend="jnp",
    )
    # But a genuinely broken rotation (above the floor AND the
    # threshold) still flags under the floors.
    broken = json.loads(json.dumps(results))
    broken[0]["metrics"]["rpe_rot_deg"] = 0.9
    assert not vo_verifier.compare_against_baseline(
        broken, path, threshold_percent=60.0,
        abs_floor=vo_verifier.CROSS_METRIC_FLOORS, backend="jnp",
    )

    thr, floor = vo_verifier.default_threshold("cpu", path)
    assert thr == vo_verifier.CPU_CROSS_HOST_THRESHOLD
    assert floor is vo_verifier.CROSS_METRIC_FLOORS
    thr, floor = vo_verifier.default_threshold("gpu", path)
    assert thr == vo_verifier.CROSS_PLATFORM_THRESHOLD
    assert floor is vo_verifier.CROSS_METRIC_FLOORS


def test_absolute_bounds_checker():
    good = [
        {
            "sequence": "strafe_x",
            "n_frames": 8,
            "metrics": {"ate_rmse": 0.006, "rpe_trans": 0.01,
                        "rpe_rot_deg": 0.18},
            "track_count": 295,
        }
    ]
    assert vo_verifier.check_absolute_bounds(good, verbose=False)
    bad = json.loads(json.dumps(good))
    bad[0]["metrics"]["ate_rmse"] = 0.05  # above the 0.03 default bound
    assert not vo_verifier.check_absolute_bounds(bad, verbose=False)
    few = json.loads(json.dumps(good))
    few[0]["track_count"] = 50
    assert not vo_verifier.check_absolute_bounds(few, verbose=False)
