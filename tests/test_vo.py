"""Visual-odometry back-end tests: SE(3) utilities, flow-based tracking,
pose-graph optimization, and bundle adjustment on synthetic problems
with known ground truth."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuflow.vo import se3, tracking, pose_graph, ba


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def test_so3_exp_log_roundtrip(rng):
    for _ in range(5):
        phi = rng.normal(0, 0.5, 3).astype(np.float32)
        r = se3.so3_exp(jnp.asarray(phi))
        back = np.asarray(se3.so3_log(r))
        np.testing.assert_allclose(back, phi, atol=1e-4)


def test_so3_exp_is_rotation(rng):
    phi = jnp.asarray(rng.normal(0, 1.0, 3).astype(np.float32))
    r = np.asarray(se3.so3_exp(phi))
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(r) - 1.0) < 1e-5


def test_se3_compose_inverse(rng):
    xi = jnp.asarray(rng.normal(0, 0.3, 6).astype(np.float32))
    r, t = se3.se3_exp(xi)
    ri, ti = se3.inverse(r, t)
    rc, tc = se3.compose(r, t, ri, ti)
    np.testing.assert_allclose(np.asarray(rc), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)


def test_small_angle_stability():
    r, t = se3.se3_exp(jnp.zeros(6))
    np.testing.assert_allclose(np.asarray(r), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.asarray(t), 0, atol=1e-7)


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def test_seed_and_advance(frame_pair):
    prev, curr = frame_pair
    tracks = tracking.seed_grid(jnp.asarray(prev), grid_step=16)
    assert int(tracks.alive.sum()) > 50  # textured image: most cells alive

    # Constant 2 px rightward flow moves every track by +2 in x.
    h, w = prev.shape
    u = jnp.full((h, w), 2.0)
    v = jnp.zeros((h, w))
    t2 = tracking.advance(tracks, u, v)
    moved = np.asarray(t2.xy - tracks.xy)[np.asarray(t2.alive)]
    np.testing.assert_allclose(moved[:, 0], 2.0, atol=1e-5)
    np.testing.assert_allclose(moved[:, 1], 0.0, atol=1e-5)


def test_tracks_die_outside(frame_pair):
    prev, _ = frame_pair
    h, w = prev.shape
    tracks = tracking.seed_grid(jnp.asarray(prev), grid_step=16)
    u = jnp.full((h, w), 1e4)  # everything leaves the frame
    t2 = tracking.advance(tracks, u, jnp.zeros((h, w)))
    assert int(t2.alive.sum()) == 0


def test_end_to_end_flow_tracking(frame_pair):
    """Dense flow from the real pipeline drives tracks by ~the true 2 px."""
    from tpuflow.flow import lucas_kanade_pyramidal

    prev, curr = frame_pair
    u, v = lucas_kanade_pyramidal(jnp.asarray(prev), jnp.asarray(curr))
    tracks = tracking.seed_grid(jnp.asarray(prev), grid_step=16)
    t2 = tracking.advance(tracks, u, v)
    alive = np.asarray(t2.alive)
    dx = np.asarray(t2.xy - tracks.xy)[alive]
    # translate_medium ground truth is (2, 0); LK underestimates but the
    # median track motion must be clearly rightward.
    assert 0.3 < np.median(dx[:, 0]) < 3.0
    assert abs(np.median(dx[:, 1])) < 0.5


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


def _random_pose(rng, scale=0.5):
    xi = rng.normal(0, scale, 6).astype(np.float32)
    return se3.se3_exp(jnp.asarray(xi))


def test_pose_graph_converges_to_ground_truth(rng):
    k = 6
    # Ground-truth chain of poses.
    gt = [se3.se3_exp(jnp.zeros(6))]
    for _ in range(k - 1):
        dr, dt = _random_pose(rng, 0.3)
        gt.append(se3.compose(gt[-1][0], gt[-1][1], dr, dt))
    gt_r = jnp.stack([g[0] for g in gt])
    gt_t = jnp.stack([g[1] for g in gt])

    # Edges: consecutive odometry + one loop closure, exact measurements.
    ei, ej, er, et = [], [], [], []
    for i in range(k - 1):
        rij, tij = se3.compose(*se3.inverse(gt_r[i], gt_t[i]), gt_r[i + 1], gt_t[i + 1])
        ei.append(i); ej.append(i + 1); er.append(rij); et.append(tij)
    rij, tij = se3.compose(*se3.inverse(gt_r[0], gt_t[0]), gt_r[k - 1], gt_t[k - 1])
    ei.append(0); ej.append(k - 1); er.append(rij); et.append(tij)

    # Initialize with perturbed poses (node 0 at ground truth = gauge).
    init_r, init_t = [gt_r[0]], [gt_t[0]]
    for i in range(1, k):
        dr, dt = _random_pose(rng, 0.1)
        r2, t2 = se3.compose(gt_r[i], gt_t[i], dr, dt)
        init_r.append(r2); init_t.append(t2)

    g = pose_graph.PoseGraph(
        poses_r=jnp.stack(init_r),
        poses_t=jnp.stack(init_t),
        edge_i=jnp.asarray(ei, jnp.int32),
        edge_j=jnp.asarray(ej, jnp.int32),
        edge_r=jnp.stack(er),
        edge_t=jnp.stack(et),
        edge_valid=jnp.ones(len(ei), bool),
        edge_weight=jnp.ones(len(ei)),
    )
    r0 = float(jnp.abs(pose_graph.residuals(g)).max())
    g = pose_graph.solve(g, iterations=15)
    r1 = float(jnp.abs(pose_graph.residuals(g)).max())
    assert r1 < 1e-3, (r0, r1)
    np.testing.assert_allclose(np.asarray(g.poses_t), np.asarray(gt_t), atol=1e-2)


def test_constant_velocity_prior_suppresses_outlier_edge():
    """A corrupted odometry edge kinks the chained trajectory; soft
    constant-velocity edges (anchored to the smooth initialization)
    pull the solution back toward uniform motion."""
    import jax.numpy as jnp

    k = 8
    step = jnp.asarray([1.0, 0.0, 0.0])
    eye = jnp.eye(3)

    # Smooth initialization: uniform unit steps along x.
    init_r = jnp.tile(eye[None], (k, 1, 1))
    init_t = jnp.stack([-i * step for i in range(k)])  # t = -R p, R=I

    # Odometry measurements: unit steps, except edge (3,4) doubled.
    ei = jnp.arange(k - 1, dtype=jnp.int32)
    ej = ei + 1
    er = jnp.tile(eye[None], (k - 1, 1, 1))
    et = np.tile(np.asarray(-step)[None], (k - 1, 1))
    et[3] = np.asarray(-2.0 * step)
    base = pose_graph.PoseGraph(
        poses_r=init_r, poses_t=init_t,
        edge_i=ei, edge_j=ej, edge_r=er, edge_t=jnp.asarray(et),
        edge_valid=jnp.ones(k - 1, bool),
        edge_weight=jnp.ones(k - 1),
    )

    def kink(g):
        pos = np.stack([
            -np.asarray(r).T @ np.asarray(t)
            for r, t in zip(g.poses_r, g.poses_t)
        ])
        dx = np.diff(pos[:, 0])
        return dx.max() - dx.min()  # 0 for perfectly uniform motion

    plain = pose_graph.solve(base, iterations=15)
    prior = pose_graph.solve(
        pose_graph.constant_velocity_edges(base, weight=1.0), iterations=15
    )
    # Without the prior the corrupted edge is satisfied exactly (kink
    # ~1 unit step); with it the step spread shrinks substantially.
    assert kink(prior) < 0.6 * kink(plain), (kink(plain), kink(prior))


# ---------------------------------------------------------------------------
# Bundle adjustment
# ---------------------------------------------------------------------------


def _make_ba_problem(rng, k=4, m=40, noise=0.0, perturb=0.05):
    intr = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    landmarks = np.stack(
        [
            rng.uniform(-2, 2, m),
            rng.uniform(-1.5, 1.5, m),
            rng.uniform(4, 8, m),
        ],
        axis=1,
    ).astype(np.float32)
    poses = []
    for i in range(k):
        xi = np.zeros(6, np.float32)
        xi[0] = 0.3 * i  # sideways translation
        xi[4] = 0.02 * i
        poses.append(se3.se3_exp(jnp.asarray(xi)))
    gt_r = jnp.stack([p[0] for p in poses])
    gt_t = jnp.stack([p[1] for p in poses])

    cams, lms, uvs = [], [], []
    for c in range(k):
        for l in range(m):
            uv = ba.project(gt_r[c], gt_t[c], jnp.asarray(landmarks[l]), intr)
            uvs.append(np.asarray(uv) + rng.normal(0, noise, 2))
            cams.append(c); lms.append(l)

    # Perturb everything except cameras 0 and 1 (7-DOF monocular gauge:
    # pose of one camera + global scale -> pin two).
    pr, pt = [gt_r[0], gt_r[1]], [gt_t[0], gt_t[1]]
    for c in range(2, k):
        dr, dt = se3.se3_exp(jnp.asarray(rng.normal(0, perturb, 6).astype(np.float32)))
        r2, t2 = se3.compose(dr, dt, gt_r[c], gt_t[c])
        pr.append(r2); pt.append(t2)
    lm_init = landmarks + rng.normal(0, perturb, landmarks.shape).astype(np.float32)

    problem = ba.BAProblem(
        poses_r=jnp.stack(pr),
        poses_t=jnp.stack(pt),
        landmarks=jnp.asarray(lm_init),
        obs_uv=jnp.asarray(np.array(uvs, np.float32)),
        obs_cam=jnp.asarray(cams, jnp.int32),
        obs_lm=jnp.asarray(lms, jnp.int32),
        obs_valid=jnp.ones(len(cams), bool),
        intrinsics=intr,
    )
    return problem, (gt_r, gt_t, jnp.asarray(landmarks))


def test_ba_reduces_reprojection_error(rng):
    problem, _ = _make_ba_problem(rng)
    e0 = float(ba.reprojection_errors(problem).mean())
    solved = ba.solve(problem, iterations=8)
    e1 = float(ba.reprojection_errors(solved).mean())
    assert e0 > 1.0
    assert e1 < 0.05, (e0, e1)


def test_ba_recovers_ground_truth_poses(rng):
    problem, (gt_r, gt_t, gt_lm) = _make_ba_problem(rng)
    # Monocular gauge is 7-DOF (pose + scale): pin two cameras at their
    # ground-truth poses so the recovered geometry is fully determined.
    solved = ba.solve(problem, iterations=12, damping=1e-5, fixed_cams=(0, 1))
    np.testing.assert_allclose(np.asarray(solved.poses_t), np.asarray(gt_t), atol=1e-2)


def test_ba_robust_to_outliers(rng):
    problem, _ = _make_ba_problem(rng)
    uv = np.array(problem.obs_uv)  # writable copy
    uv[::17] += 300.0  # gross outliers
    problem = problem._replace(obs_uv=jnp.asarray(uv))
    solved = ba.solve(problem, iterations=10, huber_delta=2.0)
    e = np.asarray(ba.reprojection_errors(solved))
    inliers = np.ones(len(e), bool)
    inliers[::17] = False
    assert e[inliers].mean() < 0.3


def test_ba_distributed_matches_single(rng):
    """Sharded-observations BA (psum reduced camera system) reaches the
    same optimum as the replicated solver.

    Step-for-step equality is not expected: the Schur complement
    cancels most of the normal equations' magnitude in this dense-
    visibility problem, so f32 summation-order differences between the
    per-shard partial sums and the global scatter-add perturb a single
    step at the 1e-2 level. Both paths must converge to the same
    solution.
    """
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    import functools
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    problem, _ = _make_ba_problem(rng)
    single = ba.solve(problem, iterations=6, adaptive=False)

    devices = np.array(jax.devices()[:4])
    mesh = Mesh(devices, ("obs",))
    n = problem.obs_uv.shape[0]
    pad = (-n) % 4
    padded = problem._replace(
        obs_uv=jnp.pad(problem.obs_uv, ((0, pad), (0, 0))),
        obs_cam=jnp.pad(problem.obs_cam, (0, pad)),
        obs_lm=jnp.pad(problem.obs_lm, (0, pad)),
        obs_valid=jnp.pad(problem.obs_valid, (0, pad)),
    )
    k = problem.poses_r.shape[0]
    m = problem.landmarks.shape[0]

    obs_spec = P("obs")
    rep = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(rep, rep, rep, obs_spec, obs_spec, obs_spec, obs_spec, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    def step(pr, pt, lm, uv, cam, lmi, valid, intr):
        prob = ba.BAProblem(pr, pt, lm, uv, cam, lmi, valid, intr)
        for _ in range(6):
            prob = ba.gauss_newton_step(
                prob, axis_name="obs", num_cams=k, num_lms=m
            )
        return prob.poses_r, prob.poses_t, prob.landmarks

    pr, pt, lm = jax.jit(step)(
        padded.poses_r, padded.poses_t, padded.landmarks,
        padded.obs_uv, padded.obs_cam, padded.obs_lm, padded.obs_valid,
        padded.intrinsics,
    )
    dist = problem._replace(poses_r=pr, poses_t=pt, landmarks=lm)
    e_dist = float(ba.reprojection_errors(dist).mean())
    e_single = float(ba.reprojection_errors(single).mean())
    assert e_dist < 0.05 and e_single < 0.05, (e_dist, e_single)
    np.testing.assert_allclose(
        np.asarray(pt), np.asarray(single.poses_t), atol=2e-2
    )


# ---------------------------------------------------------------------------
# End-to-end odometry pipeline
# ---------------------------------------------------------------------------


def test_odometry_pipeline_recovers_planar_translation():
    """Camera translating sideways over a textured fronto-parallel plane:
    frames are shifts of the base texture (image shift = fx * tx / Z).
    The pipeline (dense flow -> tracks -> BA) must recover keyframe
    translations along -x with roughly uniform spacing."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import run_odometry

    base = patterns.load_base_texture(320, 240).astype(np.float32)
    fx = fy = 300.0
    depth = 5.0
    cam_step = 0.02  # world units per frame -> 1.2 px image shift
    px_step = fx * cam_step / depth
    frames = [
        nd_shift(base, (0.0, -px_step * i), order=1, mode="nearest")
        for i in range(5)
    ]

    result = run_odometry(
        frames, (fx, fy, 160.0, 120.0), init_depth=depth, ba_iterations=10
    )
    assert result.track_count > 50
    assert result.mean_reprojection_error < 1.0, result.mean_reprojection_error

    # Camera positions in the world frame: p = -R^T t (poses store the
    # world->camera transform). Content moving -x <=> camera moving +x.
    positions = np.stack(
        [-r.T @ t for r, t in zip(result.poses_r, result.poses_t)]
    )
    assert abs(positions[0]).max() < 1e-3  # camera 0 pinned
    dx = np.diff(positions[:, 0])
    assert np.all(dx > 0), positions[:, 0]
    # Monocular scale is a gauge freedom — assert the trajectory is the
    # right shape (order-of-magnitude step size, bounded lateral drift),
    # not its absolute scale.
    assert cam_step / 4 < np.mean(dx) < cam_step * 4, dx
    span = positions[-1, 0] - positions[0, 0]
    assert np.abs(positions[1:, 1]).max() < 0.6 * span
    assert np.abs(positions[1:, 2]).max() < 0.6 * span


# ---------------------------------------------------------------------------
# Checkpoint / resume (SURVEY.md §5: back-end state persistence)
# ---------------------------------------------------------------------------


def test_odometry_checkpoint_resume_bit_identical(tmp_path):
    """Interrupting a session with save/load mid-sequence must change
    nothing: the resumed run's BA solution is bit-identical to the
    uninterrupted run's."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    base = patterns.load_base_texture(160, 120).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(5)
    ]
    intr = (150.0, 150.0, 80.0, 60.0)

    straight = OdometrySession(intr, grid_step=16)
    for f in frames:
        straight.process_frame(f)
    ref = straight.solve(ba_iterations=6)

    first = OdometrySession(intr, grid_step=16)
    for f in frames[:3]:
        first.process_frame(f)
    ckpt = tmp_path / "vo_ckpt"
    checkpoint.save(first, str(ckpt))
    assert (ckpt / "meta.json").exists()

    resumed = checkpoint.load(str(ckpt))
    assert resumed.frame_index == 2
    assert resumed.backend == "jnp"
    for f in frames[3:]:
        resumed.process_frame(f)
    out = resumed.solve(ba_iterations=6)

    assert out.keyframe_indices == ref.keyframe_indices
    np.testing.assert_array_equal(out.poses_r, ref.poses_r)
    np.testing.assert_array_equal(out.poses_t, ref.poses_t)
    np.testing.assert_array_equal(out.landmarks, ref.landmarks)
    assert out.track_count == ref.track_count


def test_run_odometry_matches_session():
    """run_odometry is a thin wrapper over OdometrySession."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession, run_odometry

    base = patterns.load_base_texture(160, 120).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.0 * i), order=1, mode="nearest")
        for i in range(3)
    ]
    intr = (150.0, 150.0, 80.0, 60.0)
    a = run_odometry(frames, intr, ba_iterations=4)
    sess = OdometrySession(intr)
    for f in frames:
        sess.process_frame(f)
    b = sess.solve(ba_iterations=4)
    np.testing.assert_array_equal(a.poses_t, b.poses_t)


def test_track_reseeding_long_sequence():
    """Dead track slots are refilled at keyframes with new landmark ids,
    so a long panning sequence keeps a live observation stream (the
    initial seeding alone would bleed out)."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    base = patterns.load_base_texture(320, 120).astype(np.float32)
    # Pan: window slides right across the wide texture -> content moves
    # left -> leftmost tracks exit the frame and die.
    frames = [base[:, 3 * i: 3 * i + 160] for i in range(11)]

    sess = OdometrySession((150.0, 150.0, 80.0, 60.0), grid_step=16)
    for f in frames:
        sess.process_frame(np.ascontiguousarray(f))

    n_slots = sess.obs_uv[0].shape[0]
    # Reseeding happened: more landmarks than slots, and the live count
    # stays healthy at the end.
    assert sess.n_landmarks > n_slots
    assert int(np.asarray(sess._tracks.alive).sum()) > 0.5 * n_slots
    assert sess.lm_first_uv.shape == (sess.n_landmarks, 2)
    # Every observation's landmark id is in range.
    all_lm = np.concatenate(sess.obs_lm)
    assert all_lm.max() < sess.n_landmarks

    result = sess.solve(ba_iterations=12)
    assert result.mean_reprojection_error < 2.0
    assert result.landmarks.shape == (sess.n_landmarks, 3)


def test_forward_backward_check_kills_occluded():
    """Tracks in a region with no correspondence (noise replaces content)
    fail the forward-backward round trip and are culled."""
    import jax.numpy as jnp

    from tpuflow.eval import patterns
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.vo import tracking

    rng_ = np.random.default_rng(3)
    base = patterns.load_base_texture(160, 120).astype(np.float32)
    prev = base.copy()
    curr = base.copy()
    curr[:, 80:] = rng_.uniform(0, 255, (120, 80)).astype(np.float32)

    p, c = jnp.asarray(prev), jnp.asarray(curr)
    tracks = tracking.seed_grid(p, grid_step=16)
    prev_xy = tracks.xy
    u, v = lucas_kanade_pyramidal(p, c)
    adv = tracking.advance(tracks, u, v)
    ub, vb = lucas_kanade_pyramidal(c, p)
    checked = tracking.forward_backward_check(adv, prev_xy, ub, vb, threshold=1.0)

    xs = np.asarray(prev_xy[:, 0])
    left = xs < 70
    right = xs > 90
    alive_before = np.asarray(adv.alive)
    alive_after = np.asarray(checked.alive)
    # The check only removes tracks, never adds.
    assert not np.any(alive_after & ~alive_before)
    # Left half (real correspondence) mostly survives; the noise half
    # loses a clearly larger fraction.
    surv_left = alive_after[left].mean()
    surv_right = alive_after[right].sum() / max(alive_before[right].sum(), 1)
    assert surv_left > 0.6
    assert surv_right < surv_left


def test_windowed_ba_fixes_old_keyframes():
    """solve(window=N) keeps poses of keyframes outside the window at
    their initialization (identity) and still refines the window."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    base = patterns.load_base_texture(160, 120).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(6)
    ]
    sess = OdometrySession((150.0, 150.0, 80.0, 60.0))
    for f in frames:
        sess.process_frame(f)
    res = sess.solve(ba_iterations=6, window=3)
    k = len(res.keyframe_indices)
    # Cameras outside the window stayed at identity/zero.
    for c in range(k - 3):
        np.testing.assert_allclose(res.poses_r[c], np.eye(3), atol=1e-6)
        np.testing.assert_allclose(res.poses_t[c], 0.0, atol=1e-6)
    # The window cameras moved.
    assert np.abs(res.poses_t[k - 1]).max() > 1e-3


def test_chunked_odometry_pose_graph():
    """Local-BA chunks fused by global pose-graph optimization recover
    the planar translation trajectory (monocular scales chained through
    the overlap edge)."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import run_odometry_chunked

    base = patterns.load_base_texture(320, 240).astype(np.float32)
    fx = fy = 300.0
    px_step = 1.2
    frames = [
        nd_shift(base, (0.0, -px_step * i), order=1, mode="nearest")
        for i in range(10)
    ]
    res = run_odometry_chunked(
        frames, (fx, fy, 160.0, 120.0), chunk_size=6, overlap=2,
        ba_iterations=8,
    )
    assert res.keyframe_indices == list(range(10))
    # Pose-graph constraints satisfied after fusion.
    assert res.mean_reprojection_error < 1e-2
    positions = np.stack(
        [-r.T @ t for r, t in zip(res.poses_r, res.poses_t)]
    )
    assert abs(positions[0]).max() < 1e-4  # node 0 pinned
    dx = np.diff(positions[:, 0])
    assert np.all(dx > 0), positions[:, 0]
    # Scale chaining keeps step sizes the same order across the chunk
    # seam (monocular local BA has a few-x step variance even unchunked;
    # without chaining, seams would jump by the chunks' arbitrary
    # relative gauge scales).
    med = np.median(dx)
    assert np.all(dx > med / 4) and np.all(dx < med * 4), dx
    # Monocular planar sequences leave a translation/rotation ambiguity
    # that drifts laterally; bound it like the unchunked test does.
    span = positions[-1, 0]
    assert np.abs(positions[1:, 1]).max() < 0.6 * span
    assert np.abs(positions[1:, 2]).max() < 0.6 * span


# ---------------------------------------------------------------------------
# Essential-matrix initialization (tpuflow.vo.epipolar)
# ---------------------------------------------------------------------------


def _two_view_scene(rng, n=60, baseline=(0.4, 0.05, 0.0), rot=(0.0, 0.06, 0.01)):
    """Synthetic two-view geometry with the ba.py convention
    (world->camera, camera 1 = identity)."""
    from tpuflow.vo import epipolar  # noqa: F401

    intr = jnp.asarray([400.0, 400.0, 160.0, 120.0])
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)],
        axis=1,
    ).astype(np.float32)
    r_rel = np.asarray(se3.so3_exp(jnp.asarray(np.asarray(rot, np.float32))))
    t_rel = np.asarray(baseline, np.float32)
    uv1 = np.stack(
        [
            400.0 * pts[:, 0] / pts[:, 2] + 160.0,
            400.0 * pts[:, 1] / pts[:, 2] + 120.0,
        ],
        axis=1,
    )
    p2 = pts @ r_rel.T + t_rel
    uv2 = np.stack(
        [
            400.0 * p2[:, 0] / p2[:, 2] + 160.0,
            400.0 * p2[:, 1] / p2[:, 2] + 120.0,
        ],
        axis=1,
    )
    return intr, pts, r_rel, t_rel, uv1.astype(np.float32), uv2.astype(np.float32)


def test_two_view_init_recovers_relative_pose(rng):
    from tpuflow.vo import epipolar

    intr, pts, r_rel, t_rel, uv1, uv2 = _two_view_scene(rng)
    init = epipolar.two_view_init(
        jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.ones(len(uv1), bool), intr,
    )
    # Rotation exact to f32/eigh tolerance.
    np.testing.assert_allclose(np.asarray(init.r), r_rel, atol=2e-3)
    # Translation recovered up to scale: direction aligned.
    t_dir = t_rel / np.linalg.norm(t_rel)
    cos = float(np.asarray(init.t) @ t_dir)
    assert cos > 0.999, cos
    # Cheirality: every point in front of both cameras.
    assert int(init.n_good) == len(uv1)
    # Triangulated depths match ground truth up to the unit-|t| scale.
    s = np.linalg.norm(t_rel)
    np.testing.assert_allclose(
        np.asarray(init.depths1) * s, pts[:, 2], rtol=0.02
    )


def test_two_view_init_ignores_invalid_rows(rng):
    from tpuflow.vo import epipolar

    intr, _, r_rel, _, uv1, uv2 = _two_view_scene(rng)
    # Corrupt half the rows but mark them invalid; result must still hold.
    uv2_bad = uv2.copy()
    uv2_bad[::2] += rng.uniform(-80, 80, (len(uv2[::2]), 2))
    valid = np.ones(len(uv1), bool)
    valid[::2] = False
    init = epipolar.two_view_init(
        jnp.asarray(uv1), jnp.asarray(uv2_bad), jnp.asarray(valid), intr
    )
    np.testing.assert_allclose(np.asarray(init.r), r_rel, atol=5e-3)


def test_triangulate_landmarks_multiview(rng):
    from tpuflow.vo import epipolar

    intr, pts, r_rel, t_rel, uv1, uv2 = _two_view_scene(rng)
    n = len(pts)
    poses_r = jnp.stack([jnp.eye(3), jnp.asarray(r_rel)])
    poses_t = jnp.stack([jnp.zeros(3), jnp.asarray(t_rel)])
    obs_uv = jnp.asarray(np.concatenate([uv1, uv2]))
    obs_cam = jnp.asarray(np.r_[np.zeros(n), np.ones(n)].astype(np.int32))
    obs_lm = jnp.asarray(np.r_[np.arange(n), np.arange(n)].astype(np.int32))
    valid = np.ones(2 * n, bool)
    valid[n + 5] = False  # landmark 5: single view -> degenerate -> fallback
    fallback = np.full((n, 3), -123.0, np.float32)
    out = np.asarray(
        epipolar.triangulate_landmarks(
            poses_r, poses_t, obs_uv, obs_cam, obs_lm,
            jnp.asarray(valid), intr, n_landmarks=n,
            fallback=jnp.asarray(fallback),
        )
    )
    keep = np.ones(n, bool)
    keep[5] = False
    np.testing.assert_allclose(out[keep], pts[keep], atol=1e-2)
    np.testing.assert_array_equal(out[5], fallback[5])


def test_essential_init_bootstraps_large_baseline():
    """Two-depth-layer sequence with a large per-frame shift (the case
    where identity-initialized BA needs LM rescue): essential-matrix
    bootstrapping must land BA at a lower reprojection error than the
    identity init at the same (small) iteration budget, with the
    trajectory monotone along the true motion axis. Layered depths both
    break the fronto-parallel planar degeneracy of the essential matrix
    and give BA real structure to explain."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    base = patterns.load_base_texture(320, 240).astype(np.float32)

    def frame(i):
        # Camera translating +x over two depth layers: shift = fx*tx/Z
        # (Z=10 top -> 3 px/frame, Z=5 bottom -> 6 px/frame).
        f = base.copy()
        f[:120] = nd_shift(base[:120], (0.0, -3.0 * i), order=1, mode="nearest")
        f[120:] = nd_shift(base[120:], (0.0, -6.0 * i), order=1, mode="nearest")
        return f

    frames = [frame(i) for i in range(4)]
    sess = OdometrySession((300.0, 300.0, 160.0, 120.0), grid_step=16)
    for f in frames:
        sess.process_frame(f)

    boot = sess.solve(ba_iterations=4, essential_init=True)
    plain = sess.solve(ba_iterations=4)
    assert boot.mean_reprojection_error < 1.6, boot.mean_reprojection_error
    assert boot.mean_reprojection_error < plain.mean_reprojection_error
    positions = np.stack(
        [-r.T @ t for r, t in zip(boot.poses_r, boot.poses_t)]
    )
    dx = np.diff(positions[:, 0])
    assert np.all(dx > 0), positions[:, 0]


# ---------------------------------------------------------------------------
# Keyframe marginalization (OdometrySession.compact)
# ---------------------------------------------------------------------------


def _translating_session(n_frames, px_step=1.2, size=(320, 120)):
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = size
    base = patterns.load_base_texture(w, h).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -px_step * i), order=1, mode="nearest")
        for i in range(n_frames)
    ]
    sess = OdometrySession((150.0, 150.0, w / 2.0, h / 2.0), grid_step=16)
    return sess, frames


def test_compact_bounds_memory_and_keeps_trajectory():
    """compact(keep_last=4) every 2 keyframes: observation records stay
    bounded, landmark table stays bounded, and the full reported
    trajectory (frozen prefix + window) is monotone with healthy
    reprojection error."""
    sess, frames = _translating_session(12)
    n_slots = None
    for i, f in enumerate(frames):
        sess.process_frame(f)
        if n_slots is None:
            n_slots = sess.obs_uv[0].shape[0]
        if i >= 4 and i % 2 == 0:
            sess.compact(keep_last=4, ba_iterations=6)
            assert len(sess.obs_uv) <= 4
            # Memory bound: landmark table ~ window-visible landmarks,
            # not the whole history.
            assert sess.n_landmarks <= 3 * n_slots

    res = sess.solve(ba_iterations=6)
    assert res.keyframe_indices == list(range(12))
    assert res.poses_r.shape == (12, 3, 3)
    assert res.mean_reprojection_error < 1.5, res.mean_reprojection_error
    positions = np.stack(
        [-r.T @ t for r, t in zip(res.poses_r, res.poses_t)]
    )
    dx = np.diff(positions[:, 0])
    assert np.all(dx > 0), positions[:, 0]
    # No wild scale jump at the compaction seams.
    med = np.median(dx)
    assert np.all(dx > med / 4) and np.all(dx < med * 4), dx


def test_compact_noop_when_window_small():
    sess, frames = _translating_session(3)
    for f in frames:
        sess.process_frame(f)
    before = len(sess.obs_uv)
    sess.compact(keep_last=8)
    assert len(sess.obs_uv) == before
    assert sess.anchor_r is None


def test_compact_checkpoint_roundtrip(tmp_path):
    """Compaction state (frozen prefix, anchors, landmark memory)
    survives checkpoint/resume bit-identically."""
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    sess, frames = _translating_session(8)
    for f in frames[:6]:
        sess.process_frame(f)
    sess.compact(keep_last=3, ba_iterations=5)
    ckpt = tmp_path / "vo_compact_ckpt"
    checkpoint.save(sess, str(ckpt))
    resumed = checkpoint.load(str(ckpt))
    assert resumed.frozen_kf == sess.frozen_kf
    np.testing.assert_array_equal(resumed.frozen_r, sess.frozen_r)
    np.testing.assert_array_equal(resumed.anchor_t, sess.anchor_t)
    np.testing.assert_array_equal(resumed.lm_xyz, sess.lm_xyz)

    for f in frames[6:]:
        sess.process_frame(f)
        resumed.process_frame(f)
    a = sess.solve(ba_iterations=5)
    b = resumed.solve(ba_iterations=5)
    np.testing.assert_array_equal(a.poses_t, b.poses_t)
    assert a.keyframe_indices == b.keyframe_indices


# ---------------------------------------------------------------------------
# Loop closure (tpuflow.vo.loop_closure)
# ---------------------------------------------------------------------------


def test_keyframe_descriptor_matching():
    """Same place under gain/offset changes matches; different place
    does not."""
    from tpuflow.eval import patterns
    from tpuflow.vo import loop_closure as lc

    base = patterns.load_base_texture(480, 120).astype(np.float32)
    a = lc.keyframe_descriptor(base[:, :160])
    a2 = lc.keyframe_descriptor(base[:, :160] * 1.3 + 20.0)  # exposure change
    b = lc.keyframe_descriptor(base[:, 300:460])
    assert float(a @ a2) > 0.999
    assert float(a @ b) < 0.8
    assert abs(float(np.linalg.norm(a)) - 1.0) < 1e-5


def test_detect_loops_separation_guard():
    from tpuflow.vo import loop_closure as lc

    rng_ = np.random.default_rng(0)
    d = rng_.normal(size=(8, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[6] = d[1]  # revisit: keyframe 6 looks like keyframe 1
    d[3] = d[2]  # too close (separation 1): must be ignored
    pairs = lc.detect_loops(d, min_separation=4, threshold=0.99)
    assert (1, 6) in [(i, j) for i, j, _ in pairs]
    assert all(j - i >= 4 for i, j, _ in pairs)


def test_chunked_odometry_loop_closure_cancels_drift():
    """Out-and-back pan returning exactly to the start: the loop edge
    between the first and last keyframes pulls the final pose back onto
    the first one, beating the open-loop (no-closure) drift."""
    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import run_odometry_chunked

    base = patterns.load_base_texture(480, 120).astype(np.float32)
    offsets = [3 * i for i in range(8)] + [3 * (14 - i) for i in range(8, 15)]
    frames = [
        np.ascontiguousarray(base[:, o : o + 160]) for o in offsets
    ]
    intr = (150.0, 150.0, 80.0, 60.0)
    open_loop = run_odometry_chunked(
        frames, intr, chunk_size=6, overlap=2, ba_iterations=6
    )
    closed = run_odometry_chunked(
        frames, intr, chunk_size=6, overlap=2, ba_iterations=6,
        loop_closure=True, loop_min_separation=6,
    )

    def end_gap(res):
        p = np.stack([-r.T @ t for r, t in zip(res.poses_r, res.poses_t)])
        span = np.abs(p[:, 0]).max()
        return float(np.linalg.norm(p[-1] - p[0])), span

    gap_open, span_open = end_gap(open_loop)
    gap_closed, span_closed = end_gap(closed)
    assert span_closed > 1e-3  # still a real trajectory, not collapsed
    # The closure must tie the endpoints together far tighter than the
    # trajectory scale (and no worse than the open loop).
    assert gap_closed < 0.1 * span_closed, (gap_closed, span_closed)
    assert gap_closed <= gap_open + 1e-6, (gap_closed, gap_open)


@pytest.mark.slow
def test_long_session_compact_bounded_memory():
    """A >=200-frame session under periodic
    compact() keeps peak state bounded and the trajectory healthy.

    Calibration (measured on the 8-device CPU mesh): peak observation
    windows 10, peak landmark table 193 (140 track slots), final reproj
    0.108 px, per-keyframe forward steps within [0.44, 2.31]x the
    median, lateral drift <= 4% of forward distance over 100 keyframes.
    Asserted bounds leave ~2x headroom on each.
    """
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    sess = OdometrySession(
        (150.0, 150.0, w / 2.0, h / 2.0), keyframe_stride=2, grid_step=16
    )
    n_slots = None
    peak_obs = peak_lm = 0
    for i in range(200):
        sess.process_frame(
            nd_shift(base, (0.0, -0.4 * i), order=1, mode="nearest")
        )
        if n_slots is None:
            n_slots = sess.obs_uv[0].shape[0]
        if len(sess.keyframes) > 10:
            sess.compact(keep_last=6, ba_iterations=6)
        peak_obs = max(peak_obs, len(sess.obs_uv))
        peak_lm = max(peak_lm, sess.n_landmarks)

    # Memory bound: window state never grows with session length.
    assert peak_obs <= 11
    assert peak_lm <= 2 * n_slots
    res = sess.solve(ba_iterations=6)
    assert len(res.keyframe_indices) == 100
    assert res.mean_reprojection_error < 0.5
    pos = np.stack([-r.T @ t for r, t in zip(res.poses_r, res.poses_t)])
    dx = np.diff(pos[:, 0])
    assert np.all(dx > 0)  # monotone forward motion, no seam reversals
    med = np.median(dx)
    assert np.all(dx > med / 4) and np.all(dx < med * 4)
    # Drift bound: lateral wander <= 10% of forward distance.
    fwd = pos[-1, 0] - pos[0, 0]
    assert np.abs(pos[:, 1]).max() < 0.10 * fwd
    assert np.abs(pos[:, 2]).max() < 0.10 * fwd


@pytest.mark.slow
def test_compact_trajectory_matches_uncompacted():
    """The marginalized (drop + anchor) session's trajectory stays
    within tolerance of the full uncompacted solve on the same frames
    (normalized by total path length — monocular gauge). Measured max
    normalized deviation 0.080; asserted 0.15.
    """
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.0 * i), order=1, mode="nearest")
        for i in range(40)
    ]

    def run(compact):
        sess = OdometrySession((150.0, 150.0, w / 2.0, h / 2.0), grid_step=16)
        for f in frames:
            sess.process_frame(f)
            if compact and len(sess.keyframes) > 8:
                sess.compact(keep_last=6, ba_iterations=6)
        res = sess.solve(ba_iterations=8)
        return np.stack([-r.T @ t for r, t in zip(res.poses_r, res.poses_t)])

    pc = run(True)
    pu = run(False)

    def norm(p):
        return (p - p[0]) / np.linalg.norm(p[-1] - p[0])

    dev = np.abs(norm(pc) - norm(pu)).max()
    assert dev < 0.15, dev


# ---------------------------------------------------------------------------
# Degenerate-input robustness (SURVEY §5 failure detection/recovery)
# ---------------------------------------------------------------------------


def test_textureless_frames_give_identity_poses():
    """Uniform frames: the det gate zeroes all flow, tracks never move,
    and the solve must return finite, ~identity poses instead of NaNs
    (the reference's untextured-window -> zero-flow contract carried
    through the whole back-end)."""
    from tpuflow.vo.pipeline import OdometrySession

    flat = np.full((120, 160), 128.0, np.float32)
    sess = OdometrySession((100.0, 100.0, 80.0, 60.0), grid_step=16)
    for _ in range(5):
        sess.process_frame(flat)
    res = sess.solve(ba_iterations=5)
    assert np.all(np.isfinite(res.poses_r))
    assert np.all(np.isfinite(res.poses_t))
    assert np.all(np.isfinite(res.landmarks))
    # No apparent motion => trajectory stays at the origin.
    pos = np.stack([-r.T @ t for r, t in zip(res.poses_r, res.poses_t)])
    assert np.abs(pos).max() < 0.15, pos


def test_pure_rotation_stays_finite():
    """Pure in-place rotation: monocular triangulation is degenerate
    (no baseline), so the quality bar is survival — finite poses and
    landmarks, no exploding trajectory."""
    import cv2

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 240, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    sess = OdometrySession((150.0, 150.0, w / 2.0, h / 2.0), grid_step=16)
    for i in range(6):
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), 0.8 * i, 1.0)
        frame = cv2.warpAffine(
            base, m, (w, h), flags=cv2.INTER_LINEAR, borderValue=128
        ).astype(np.float32)
        sess.process_frame(frame)
    res = sess.solve(ba_iterations=6)
    assert np.all(np.isfinite(res.poses_r))
    assert np.all(np.isfinite(res.poses_t))
    pos = np.stack([-r.T @ t for r, t in zip(res.poses_r, res.poses_t)])
    # In-place rotation: translation stays small relative to the scene
    # depth prior (5.0).
    assert np.abs(pos).max() < 2.0, pos


def test_violent_motion_culls_tracks_but_survives():
    """Motion far beyond the trackable band: forward-backward culling
    kills bad tracks, reseeding refills them, and the session still
    produces a finite solve."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 240, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    sess = OdometrySession(
        (150.0, 150.0, w / 2.0, h / 2.0), grid_step=16,
        fb_check_threshold=1.0,
    )
    for i in range(5):
        # 25 px/frame — far beyond the +-8 px pyramid budget.
        sess.process_frame(
            nd_shift(base, (0.0, -25.0 * i), order=1, mode="nearest")
        )
    res = sess.solve(ba_iterations=5)
    assert np.all(np.isfinite(res.poses_r))
    assert np.all(np.isfinite(res.poses_t))
    assert np.all(np.isfinite(res.landmarks))


def test_tiled_flow_session_matches_untiled():
    """OdometrySession(mesh=...): the front-end dense flow runs
    spatially tiled across the device mesh (BASELINE config 5's
    multi-host tiled flow feeding the BA back-end). Tiled flow carries
    the fast-path saturation semantics (backend "xla"), so the reference
    point is an untiled session with the same clamped flow. The strong
    guarantee is at the FRONT-END: identical track observations (tiled
    flow == untiled to ~1e-4 px). The monocular BA on a short planar
    sequence is ill-conditioned enough that 1e-5 px observation dust
    still moves the solution a few percent (measured), so the
    trajectory check is correspondingly loose."""
    import jax
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.sharding import make_flow_mesh
    from tpuflow.vo.pipeline import OdometrySession

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    w, h = 128, 64
    base = patterns.load_base_texture(w, h).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(6)
    ]

    def run(mesh_arg, clamp_ref=False):
        sess = OdometrySession(
            (80.0, 80.0, w / 2.0, h / 2.0), grid_step=16, mesh=mesh_arg
        )
        if clamp_ref:
            from tpuflow.vo.device_loop import FrontEnd

            sess._fe = FrontEnd(
                grid_step=16, keyframe_stride=1, backend="xla",
            )
        for f in frames:
            sess.process_frame(f)
        return sess

    st = run(mesh)
    ss = run(None, clamp_ref=True)
    # Front-end guarantee: identical tracking from the tiled flow.
    for uv_t, uv_s, va_t, va_s in zip(
        st.obs_uv, ss.obs_uv, st.obs_valid, ss.obs_valid
    ):
        np.testing.assert_array_equal(np.asarray(va_t), np.asarray(va_s))
        both = np.asarray(va_t)
        np.testing.assert_allclose(uv_t[both], uv_s[both], atol=1e-3)

    rt = st.solve(ba_iterations=6)
    rs = ss.solve(ba_iterations=6)
    assert rt.mean_reprojection_error < 0.5
    assert rs.mean_reprojection_error < 0.5
    pos_t = np.stack([-r.T @ t for r, t in zip(rt.poses_r, rt.poses_t)])
    pos_s = np.stack([-r.T @ t for r, t in zip(rs.poses_r, rs.poses_t)])
    scale = np.linalg.norm(pos_s[-1] - pos_s[0])
    assert scale > 0
    np.testing.assert_allclose(pos_t / scale, pos_s / scale, atol=0.15)


def test_tracking_loss_detection_and_persistence(tmp_path):
    """Total occlusion mid-sequence: the session records the loss frame
    (once per contiguous loss), recovers by reseeding, reports the
    event in the solve result, and persists it through checkpoint."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    blank = np.full((h, w), 128.0, np.float32)
    sess = OdometrySession(
        (150.0, 150.0, w / 2.0, h / 2.0), grid_step=16,
        fb_check_threshold=1.0,
    )
    for i in range(4):
        sess.process_frame(
            nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        )
    sess.process_frame(blank)
    sess.process_frame(blank)  # still lost: no second event
    for i in range(3):
        sess.process_frame(
            nd_shift(base, (0.0, -1.2 * (6 + i)), order=1, mode="nearest")
        )
    assert sess.track_loss_frames == [4]
    res = sess.solve(ba_iterations=5)
    assert res.track_loss_frames == [4]
    assert np.all(np.isfinite(res.poses_t))

    ckpt = tmp_path / "loss_ckpt"
    checkpoint.save(sess, str(ckpt))
    resumed = checkpoint.load(str(ckpt))
    assert resumed.track_loss_frames == [4]
    assert resumed._tracking_lost is False


def test_mesh_resume_guard(tmp_path):
    """A tiled session cannot be silently resumed untiled (and vice
    versa): the flow saturation semantics differ (code-review r2
    finding). The mesh must be re-passed to checkpoint.load."""
    import jax
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.sharding import make_flow_mesh
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    w, h = 128, 64
    base = patterns.load_base_texture(w, h).astype(np.float32)
    sess = OdometrySession((80.0, 80.0, w / 2.0, h / 2.0), grid_step=16,
                           mesh=mesh)
    for i in range(3):
        sess.process_frame(
            nd_shift(base, (0.0, -1.0 * i), order=1, mode="nearest")
        )
    ckpt = tmp_path / "tiled_ckpt"
    checkpoint.save(sess, str(ckpt))
    with pytest.raises(ValueError, match="mesh-tiled"):
        checkpoint.load(str(ckpt))
    resumed = checkpoint.load(str(ckpt), mesh=mesh)
    assert resumed.mesh is mesh
    # Untiled checkpoints reject a mesh on resume too.
    plain = OdometrySession((80.0, 80.0, w / 2.0, h / 2.0), grid_step=16)
    plain.process_frame(base)
    plain.process_frame(base)
    ckpt2 = tmp_path / "plain_ckpt"
    checkpoint.save(plain, str(ckpt2))
    with pytest.raises(ValueError, match="untiled"):
        checkpoint.load(str(ckpt2), mesh=mesh)


def test_chunked_aggregates_track_loss_frames():
    """run_odometry_chunked surfaces per-chunk loss events as GLOBAL
    frame indices, deduped across chunk overlaps (code-review r3 medium
    finding: the chunked result used to silently drop them)."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import run_odometry_chunked

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    blank = np.full((h, w), 128.0, np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(4)
    ] + [blank, blank] + [
        nd_shift(base, (0.0, -1.2 * (6 + i)), order=1, mode="nearest")
        for i in range(3)
    ]
    res = run_odometry_chunked(
        frames, (150.0, 150.0, w / 2.0, h / 2.0),
        chunk_size=5, grid_step=16, ba_iterations=4,
        fb_check_threshold=1.0,
    )
    # The occlusion at frame 4 is seen by two overlapping chunks; the
    # aggregate must report it once, at the global index.
    assert res.track_loss_frames == [4]


def test_loss_compact_resume_chain(tmp_path):
    """Fresh session -> tracking loss -> compact() -> checkpoint ->
    resume -> continue: the loss record and the compacted state both
    survive the full chain, and the resumed session keeps processing
    identically to the uninterrupted one."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    blank = np.full((h, w), 128.0, np.float32)

    def seq():
        for i in range(4):
            yield nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        yield blank
        for i in range(4):
            yield nd_shift(
                base, (0.0, -1.2 * (5 + i)), order=1, mode="nearest"
            )

    frames = list(seq())
    sess = OdometrySession(
        (150.0, 150.0, w / 2.0, h / 2.0), grid_step=16,
        fb_check_threshold=1.0,
    )
    for f in frames[:7]:
        sess.process_frame(f)
    assert sess.track_loss_frames == [4]
    sess.compact(keep_last=3, ba_iterations=4)
    ckpt = tmp_path / "chain_ckpt"
    checkpoint.save(sess, str(ckpt))

    resumed = checkpoint.load(str(ckpt))
    assert resumed.track_loss_frames == [4]
    assert resumed.frozen_kf == sess.frozen_kf
    for f in frames[7:]:
        sess.process_frame(f)
        resumed.process_frame(f)
    r1 = sess.solve(ba_iterations=4)
    r2 = resumed.solve(ba_iterations=4)
    assert r1.track_loss_frames == r2.track_loss_frames == [4]
    np.testing.assert_allclose(r1.poses_t, r2.poses_t, atol=1e-5)
    np.testing.assert_array_equal(r1.keyframe_indices, r2.keyframe_indices)


def test_process_frames_scan_matches_eager():
    """The single-dispatch scan path (process_frames) produces the same
    session as per-frame process_frame calls: same keyframes, same
    observations, same loss events, same solution — including keyframe
    stride > 1, fb-check, an occlusion, and chunked scan calls."""
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo.pipeline import OdometrySession

    w, h = 320, 120
    base = patterns.load_base_texture(w, h).astype(np.float32)
    blank = np.full((h, w), 128.0, np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(4)
    ] + [blank] + [
        nd_shift(base, (0.0, -1.2 * (5 + i)), order=1, mode="nearest")
        for i in range(4)
    ]

    def make():
        return OdometrySession(
            (150.0, 150.0, w / 2.0, h / 2.0), grid_step=16,
            keyframe_stride=2, fb_check_threshold=1.0,
        )

    eager = make()
    for f in frames:
        eager.process_frame(f)
    scanned = make()
    scanned.process_frames(np.stack(frames[:5]))  # first chunk
    scanned.process_frames(np.stack(frames[5:]))  # continuation chunk

    assert scanned.frame_index == eager.frame_index == len(frames) - 1
    assert scanned.keyframes == eager.keyframes
    assert scanned.track_loss_frames == eager.track_loss_frames
    assert len(scanned.obs_uv) == len(eager.obs_uv)
    for uv_s, uv_e, lm_s, lm_e, va_s, va_e in zip(
        scanned.obs_uv, eager.obs_uv, scanned.obs_lm, eager.obs_lm,
        scanned.obs_valid, eager.obs_valid,
    ):
        np.testing.assert_array_equal(va_s, va_e)
        np.testing.assert_array_equal(lm_s, lm_e)
        np.testing.assert_allclose(uv_s[va_s], uv_e[va_e], atol=1e-4)
    assert scanned.n_landmarks == eager.n_landmarks
    np.testing.assert_allclose(
        scanned.lm_first_uv, eager.lm_first_uv, atol=1e-4
    )
    np.testing.assert_array_equal(scanned.lm_first_kf, eager.lm_first_kf)

    rs = scanned.solve(ba_iterations=4)
    re_ = eager.solve(ba_iterations=4)
    np.testing.assert_allclose(rs.poses_t, re_.poses_t, atol=1e-3)
    assert rs.track_loss_frames == re_.track_loss_frames


def test_loss_detection_peak_relative():
    """Sparse-texture scenes (few seedable cells) must NOT read as
    tracking loss: the threshold is relative to the session's peak
    alive count, not grid capacity (code-review r2 finding)."""
    from tpuflow.vo.pipeline import OdometrySession

    h, w = 120, 160
    # Texture only in a small patch: most grid cells never seed.
    rng_ = np.random.default_rng(7)
    frame = np.full((h, w), 128.0, np.float32)
    frame[40:80, 60:100] = rng_.uniform(0, 255, (40, 40)).astype(np.float32)
    sess = OdometrySession((100.0, 100.0, w / 2.0, h / 2.0), grid_step=16)
    for _ in range(4):
        sess.process_frame(frame.copy())
    assert sess.track_loss_frames == []  # stable sparse scene: no loss


def test_session_pyramid_config_applied_and_checkpointed(tmp_path):
    """The session's named flow config reaches the front-end (a 2-level
    'shallow' run measurably differs from the 3-level default) and
    round-trips through checkpoint meta — the resumed session continues
    bit-identically to an uninterrupted shallow session."""
    import pytest as _pytest
    from scipy.ndimage import shift as nd_shift

    from tpuflow.eval import patterns
    from tpuflow.vo import checkpoint
    from tpuflow.vo.pipeline import OdometrySession

    with _pytest.raises(ValueError):
        OdometrySession((150.0, 150.0, 80.0, 60.0), pyramid_config="nope")

    base = patterns.load_base_texture(160, 120).astype(np.float32)
    frames = [
        nd_shift(base, (0.0, -1.2 * i), order=1, mode="nearest")
        for i in range(5)
    ]
    intr = (150.0, 150.0, 80.0, 60.0)

    def run(cfg, split=None, tmp=None):
        s = OdometrySession(intr, grid_step=16, pyramid_config=cfg)
        if split is None:
            for f in frames:
                s.process_frame(f)
            return s.solve(ba_iterations=6)
        for f in frames[:split]:
            s.process_frame(f)
        checkpoint.save(s, str(tmp))
        r = checkpoint.load(str(tmp))
        assert r.pyramid_config == cfg
        for f in frames[split:]:
            r.process_frame(f)
        return r.solve(ba_iterations=6)

    ref_default = run("default")
    ref_shallow = run("shallow")
    # The config changes the flow program (different pyramid depth).
    assert not np.array_equal(ref_shallow.poses_t, ref_default.poses_t)
    # Resume preserves the config and the bit-identical contract.
    resumed = run("shallow", split=3, tmp=tmp_path / "ck")
    np.testing.assert_array_equal(resumed.poses_r, ref_shallow.poses_r)
    np.testing.assert_array_equal(resumed.poses_t, ref_shallow.poses_t)


def test_sample_flow_matches_map_coordinates(rng):
    """The r5 single-gather sample_flow is value-identical to the
    per-plane map_coordinates form it replaced (same corner clamping,
    lerp order, and hard-OOB zero) — including fractional, border, and
    out-of-bounds positions."""
    import jax.numpy as jnp

    from tpuflow.core import ops
    from tpuflow.vo import tracking

    h, w = 37, 53
    u = jnp.asarray(rng.uniform(-5, 5, (h, w)), jnp.float32)
    v = jnp.asarray(rng.uniform(-5, 5, (h, w)), jnp.float32)
    xy = np.concatenate([
        rng.uniform(-2, w + 2, (300, 1)),
        rng.uniform(-2, h + 2, (300, 1)),
    ], axis=1).astype(np.float32)
    # Exact corners and edges too.
    xy = np.concatenate([xy, np.float32([[0, 0], [w - 1, h - 1], [0.5, 0],
                                         [w - 1.5, h - 1.0]])])
    got = np.asarray(tracking.sample_flow(u, v, jnp.asarray(xy)))
    ref = np.stack([
        np.asarray(ops.map_coordinates_bilinear(
            u, jnp.asarray(xy[:, 1]), jnp.asarray(xy[:, 0]))),
        np.asarray(ops.map_coordinates_bilinear(
            v, jnp.asarray(xy[:, 1]), jnp.asarray(xy[:, 0]))),
    ], axis=1)
    np.testing.assert_array_equal(got, ref)


def test_reseed_skip_is_noop_when_all_alive(rng):
    """The r5 dead-slot gate on keyframe reseeding: when no slot is
    dead the cond skips the Shi-Tomasi reseed entirely, and the
    resulting table must be exactly what the ungated reseed produced —
    i.e. unchanged (reseeding zero dead slots is a no-op: ``good =
    fresh.alive & ~alive`` is all-false and mints nothing)."""
    from tpuflow.vo.device_loop import FrontEnd

    # Raw noise = strong corner response in every cell -> every slot
    # alive at init; zero motion -> zero flow -> no culls. The frame is
    # big enough (min dim >= 16x the border stripe) that seed and cull
    # use the SAME full-stripe margin — on smaller frames the legacy
    # margins (seed 0 / cull 3) churn border slots by design.
    base = rng.uniform(0, 255, (224, 224)).astype(np.float32)
    fe = FrontEnd(grid_step=16, keyframe_stride=1, backend="jnp")
    state, _obs0 = fe.init(base)
    assert bool(np.asarray(state.alive).all())
    state1, _obs1 = fe.step(state, base)
    assert np.array_equal(np.asarray(state1.alive), np.asarray(state.alive))
    assert int(state1.n_landmarks) == int(state.n_landmarks)
    assert np.array_equal(np.asarray(state1.track_lm),
                          np.asarray(state.track_lm))
    assert np.array_equal(np.asarray(state1.xy), np.asarray(state.xy))
