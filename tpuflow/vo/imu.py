"""IMU preintegration and gyro-aided pose-graph factors.

On-manifold preintegration in the style of Forster et al. (PAPERS.md):
between two keyframe timestamps, raw gyro/accelerometer samples are
integrated ONCE into relative motion increments (dR, dv, dp) that are
independent of the absolute state — the standard trick that keeps IMU
rates (100-1000 Hz) out of the optimizer. The integrator is a
``lax.scan`` (jittable, differentiable).

What is wired into the trajectory solver: **gyro orientation factors**.
Monocular VO's rotation estimate drifts with texture; the preintegrated
gyro dR between consecutive keyframes is a direct, scale-free
measurement of the same quantity, added to the pose graph as
rotation-only edges (``PoseGraph.edge_mask`` zeroes the translation
components, which a gyro does not observe). Accelerometer increments
(dv, dp) are computed and tested but not yet tied into the graph —
full IMU factors need velocity + bias states per keyframe, a larger
state-space change left as future work (ROADMAP R5).

No reference counterpart (the reference stops at dense flow);
SURVEY.md §5 lists the VO back-end as new-framework territory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.vo import se3
from tpuflow.vo._precision import pin_matmul_precision


class ImuIncrement(NamedTuple):
    """Preintegrated motion over one interval, in the frame of the
    starting body pose."""

    delta_r: jax.Array  # (3, 3) rotation increment
    delta_v: jax.Array  # (3,) velocity increment (gravity-free)
    delta_p: jax.Array  # (3,) position increment (gravity-free)
    dt: jax.Array       # scalar total duration
    # Number of raw samples integrated. 0 = the interval had NO IMU
    # coverage (identity/zero increment by construction) — consumers
    # must treat such increments as missing data, not as a measured
    # "no motion" (a weight-2 zero-rotation edge built from one would
    # actively corrupt a rotating trajectory).
    n_samples: int = 0
    # First-order bias Jacobians (Forster et al. recursions), so a bias
    # update db re-corrects the increments WITHOUT re-integrating:
    #   dR(b+db_g) ~= dR Exp(j_r_bg db_g)
    #   dv(b+db)   ~= dv + j_v_bg db_g + j_v_ba db_a
    #   dp(b+db)   ~= dp + j_p_bg db_g + j_p_ba db_a
    # (tpuflow.vo.vi_graph estimates the shared biases this way.)
    j_r_bg: jax.Array | None = None   # (3, 3)
    j_v_bg: jax.Array | None = None
    j_v_ba: jax.Array | None = None
    j_p_bg: jax.Array | None = None
    j_p_ba: jax.Array | None = None


@pin_matmul_precision
def preintegrate(
    gyro: jax.Array,
    accel: jax.Array,
    dt: jax.Array | float,
    gyro_bias: jax.Array | None = None,
    accel_bias: jax.Array | None = None,
    bias_jacobians: bool = False,
) -> ImuIncrement:
    """Integrate raw IMU samples into an :class:`ImuIncrement`.

    gyro, accel: (N, 3) body-frame angular velocity (rad/s) and specific
    force (m/s^2). ``dt``: scalar sample period or (N,) per-sample
    periods. Midpoint-free first-order scheme (each sample held for its
    dt):

        dR_{k+1} = dR_k @ Exp((w_k - b_g) dt)
        dv_{k+1} = dv_k + dR_k (a_k - b_a) dt
        dp_{k+1} = dp_k + dv_k dt + 0.5 dR_k (a_k - b_a) dt^2

    Gravity is NOT removed here (raw specific force is integrated, as in
    standard preintegration); consumers subtract g at the factor level.

    ``bias_jacobians=True`` additionally accumulates the five 3x3
    first-order bias Jacobians (five extra small matmuls per sample —
    off by default so the common gyro-edge / alignment paths stay
    cheap; vo.vi_graph's bias estimation needs them).
    """
    gyro = jnp.asarray(gyro, jnp.float32)
    accel = jnp.asarray(accel, jnp.float32)
    n = gyro.shape[0]
    dts = jnp.broadcast_to(jnp.asarray(dt, jnp.float32), (n,))
    if gyro_bias is not None:
        gyro = gyro - jnp.asarray(gyro_bias, jnp.float32)
    if accel_bias is not None:
        accel = accel - jnp.asarray(accel_bias, jnp.float32)

    if bias_jacobians:
        def step_j(carry, sample):
            r, v, p, j_r, j_vg, j_va, j_pg, j_pa = carry
            w, a, h = sample
            a_world = r @ a
            # Bias Jacobians first (they use the PRE-update r, j_r, j_v*).
            a_hat = se3.hat(a)
            j_pg = j_pg + j_vg * h - 0.5 * (r @ a_hat @ j_r) * h * h
            j_pa = j_pa + j_va * h - 0.5 * r * h * h
            j_vg = j_vg - (r @ a_hat @ j_r) * h
            j_va = j_va - r * h
            step_r = se3.so3_exp(w * h)
            j_r = step_r.T @ j_r - se3.so3_right_jacobian(w * h) * h
            p = p + v * h + 0.5 * a_world * h * h
            v = v + a_world * h
            r = r @ step_r
            return (r, v, p, j_r, j_vg, j_va, j_pg, j_pa), None

        z33 = jnp.zeros((3, 3))
        init = (
            jnp.eye(3), jnp.zeros(3), jnp.zeros(3), z33, z33, z33, z33, z33,
        )
        (r, v, p, j_r, j_vg, j_va, j_pg, j_pa), _ = jax.lax.scan(
            step_j, init, (gyro, accel, dts)
        )
        return ImuIncrement(
            delta_r=r, delta_v=v, delta_p=p, dt=dts.sum(), n_samples=n,
            j_r_bg=j_r, j_v_bg=j_vg, j_v_ba=j_va, j_p_bg=j_pg, j_p_ba=j_pa,
        )

    def step(carry, sample):
        r, v, p = carry
        w, a, h = sample
        a_world = r @ a
        p = p + v * h + 0.5 * a_world * h * h
        v = v + a_world * h
        r = r @ se3.so3_exp(w * h)
        return (r, v, p), None

    init = (jnp.eye(3), jnp.zeros(3), jnp.zeros(3))
    (r, v, p), _ = jax.lax.scan(step, init, (gyro, accel, dts))
    return ImuIncrement(
        delta_r=r, delta_v=v, delta_p=p, dt=dts.sum(), n_samples=n
    )


def preintegrate_segments(
    times: np.ndarray,
    gyro: np.ndarray,
    accel: np.ndarray,
    boundaries: np.ndarray,
    bias_jacobians: bool = False,
) -> list[ImuIncrement]:
    """Split a sample stream at ``boundaries`` timestamps and
    preintegrate each [b_k, b_{k+1}) segment.

    ``times``: (N,) monotone sample timestamps; ``boundaries``: (K,)
    monotone keyframe timestamps. Returns K-1 increments. Samples
    outside [b_0, b_{K-1}) are ignored. Segment lengths vary, so this
    is a host-side loop (back-end path, not the serving loop); the
    per-segment integration is the jitted scan.
    """
    times = np.asarray(times, np.float64)
    boundaries = np.asarray(boundaries, np.float64)
    if len(boundaries) < 2:
        return []
    if not (np.diff(times) > 0).all():
        raise ValueError("IMU timestamps must be strictly increasing")
    if not (np.diff(boundaries) > 0).all():
        raise ValueError("boundary timestamps must be strictly increasing")
    out = []
    # Sample k covers [t_k, t_{k+1}); the last sample gets the median dt.
    dts = np.diff(times)
    dts = np.append(dts, np.median(dts) if len(dts) else 0.0)
    for k in range(len(boundaries) - 1):
        lo, hi = boundaries[k], boundaries[k + 1]
        sel = (times >= lo) & (times < hi)
        if not sel.any():
            out.append(
                ImuIncrement(
                    delta_r=jnp.eye(3), delta_v=jnp.zeros(3),
                    delta_p=jnp.zeros(3), dt=jnp.asarray(hi - lo, jnp.float32),
                    n_samples=0,
                )
            )
            continue
        out.append(
            preintegrate(
                gyro[sel], accel[sel], dts[sel],
                bias_jacobians=bias_jacobians,
            )
        )
    return out


def estimate_scale_and_gravity(
    poses_r: np.ndarray,
    poses_t: np.ndarray,
    increments: list[ImuIncrement],
    r_cam_imu: np.ndarray | None = None,
) -> tuple[float, np.ndarray, np.ndarray, float]:
    """Visual-inertial alignment: recover the monocular metric scale.

    Monocular VO's trajectory is defined up to scale; the accelerometer
    observes metric distances. Given the solved (up-to-scale)
    world->camera keyframe poses and the preintegrated gravity-free
    increments between consecutive keyframes, solve the classic linear
    alignment system (Mur-Artal-style VI initialization) for scale s,
    gravity vector g (VO world frame), and per-keyframe velocities:

        s(p_{i+1} - p_i) = v_i dt_i + 0.5 g dt_i^2 + R_cw_i dp_i
        v_{i+1} - v_i    = g dt_i + R_cw_i dv_i

    ``r_cam_imu``: camera-from-IMU rotation extrinsic — increments are
    integrated in the IMU body frame and must be re-expressed in camera
    axes before the camera-pose rotations map them to world (the same
    extrinsic ``gyro_rotation_edges`` applies).

    Returns ``(scale, gravity (3,), velocities (K, 3), residual_rms)``.
    Needs K >= 4 keyframes and real acceleration variation to be well
    conditioned (constant velocity makes scale/gravity nearly
    unobservable — check ``residual_rms`` and |gravity| ≈ 9.81 before
    trusting the scale). Host-side lstsq (an initialization step, not
    the serving loop).
    """
    k = len(poses_r)
    if len(increments) != k - 1:
        raise ValueError(
            f"need K-1={k - 1} increments for K={k} poses, got {len(increments)}"
        )
    if k < 4:
        raise ValueError("scale/gravity alignment needs >= 4 keyframes")
    poses_r = np.asarray(poses_r, np.float64)
    poses_t = np.asarray(poses_t, np.float64)
    centers = -np.einsum("kij,ki->kj", poses_r, poses_t)  # up-to-scale p_hat
    r_cw = np.transpose(poses_r, (0, 2, 1))               # camera->world
    if r_cam_imu is not None:
        # Fold the extrinsic in once: IMU-frame vectors -> camera ->
        # world is r_cw_i @ r_cam_imu.
        r_cw = r_cw @ np.asarray(r_cam_imu, np.float64)

    n_unknown = 1 + 3 + 3 * k                # s, g, v_0..v_{K-1}
    rows = []
    rhs = []
    for i in range(k - 1):
        dt = float(increments[i].dt)
        dp = r_cw[i] @ np.asarray(increments[i].delta_p, np.float64)
        dv = r_cw[i] @ np.asarray(increments[i].delta_v, np.float64)
        # Position block: s dp_hat - v_i dt - 0.5 dt^2 g = dp
        a = np.zeros((3, n_unknown))
        a[:, 0] = centers[i + 1] - centers[i]
        a[:, 1:4] = -0.5 * dt * dt * np.eye(3)
        a[:, 4 + 3 * i : 7 + 3 * i] = -dt * np.eye(3)
        rows.append(a)
        rhs.append(dp)
        # Velocity block: v_{i+1} - v_i - dt g = dv
        b = np.zeros((3, n_unknown))
        b[:, 1:4] = -dt * np.eye(3)
        b[:, 4 + 3 * i : 7 + 3 * i] = -np.eye(3)
        b[:, 4 + 3 * (i + 1) : 7 + 3 * (i + 1)] = np.eye(3)
        rows.append(b)
        rhs.append(dv)
    a_mat = np.concatenate(rows)
    b_vec = np.concatenate(rhs)
    x, _, _, _ = np.linalg.lstsq(a_mat, b_vec, rcond=None)
    resid = a_mat @ x - b_vec
    rms = float(np.sqrt(np.mean(resid * resid)))
    return float(x[0]), x[1:4], x[4:].reshape(k, 3), rms


def gyro_rotation_edges(
    g,
    increments: list[ImuIncrement],
    node_pairs: list[tuple[int, int]],
    weight: float = 2.0,
    r_cam_imu: np.ndarray | None = None,
):
    """Append rotation-only gyro edges to a :class:`PoseGraph`.

    Each increment's dR measures the body-frame rotation between the two
    keyframes of ``node_pairs[k]`` (cam->world propagates as
    ``R_cw_j = R_cw_i @ dR``). The graph's edge convention is
    ``T_i^-1 T_j`` on world->camera poses, whose rotation block is
    ``R_i^T R_j = R_i^T dR^T R_i`` — the body increment conjugated by
    the ABSOLUTE rotation of node i. The conjugation anchors to the
    graph's call-time pose estimates (the odometry-chained
    initialization), exactly as ``constant_velocity_edges`` anchors its
    predictions; with the extrinsic ``r_cam_imu`` (camera-from-IMU
    rotation, identity default) the body increment is first re-expressed
    in camera axes. Correctness of the convention is pinned by
    tests/test_vo_imu.py::test_gyro_edges_fix_corrupted_rotations on a
    rotating ground-truth trajectory. Translation components are masked
    out (``PoseGraph.edge_mask``): a gyro observes no translation, and
    an unmasked zero-translation measurement would drag keyframes
    together. ``weight`` > the odometry edges' 1.0 reflects the gyro's
    much lower rotation noise.
    """
    from tpuflow.vo.pose_graph import _mask_of

    if len(increments) != len(node_pairs):
        raise ValueError(
            f"{len(increments)} increments for {len(node_pairs)} node pairs"
        )
    if not increments:
        return g
    r_ci = (
        jnp.eye(3) if r_cam_imu is None
        else jnp.asarray(r_cam_imu, jnp.float32)
    )
    e = len(node_pairs)
    er = jnp.stack(
        [
            g.poses_r[i].T @ (r_ci @ inc.delta_r @ r_ci.T).T @ g.poses_r[i]
            for (i, _j), inc in zip(node_pairs, increments)
        ]
    )
    mask_old = _mask_of(g)
    mask_new = jnp.tile(
        jnp.asarray([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], jnp.float32), (e, 1)
    )
    return g._replace(
        edge_i=jnp.concatenate(
            [g.edge_i, jnp.asarray([i for i, _ in node_pairs], jnp.int32)]
        ),
        edge_j=jnp.concatenate(
            [g.edge_j, jnp.asarray([j for _, j in node_pairs], jnp.int32)]
        ),
        edge_r=jnp.concatenate([g.edge_r, er]),
        edge_t=jnp.concatenate([g.edge_t, jnp.zeros((e, 3))]),
        edge_valid=jnp.concatenate([g.edge_valid, jnp.ones(e, bool)]),
        edge_weight=jnp.concatenate(
            [g.edge_weight, jnp.full(e, float(weight), jnp.float32)]
        ),
        edge_mask=jnp.concatenate([mask_old, mask_new]),
    )
