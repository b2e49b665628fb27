"""Essential-matrix relative-pose initialization for the VO back-end.

Large-baseline bootstrapping: bundle adjustment initialized from
identity poses + flat ``init_depth`` landmarks converges slowly (or only
thanks to Levenberg-Marquardt rescue) once the baseline between
keyframes grows. The classic fix is a closed-form two-view
initialization — weighted 8-point essential matrix, cheirality-voted
decomposition, linear triangulation — which this module provides as
jit/vmap-friendly JAX.

No reference counterpart (/root/reference stops at dense flow); this is
back-end territory the BASELINE.json north star mandates. Pose
convention matches tpuflow.vo.ba: world->camera, ``x_cam = R X + t``;
the relative pose (R, t) of a pair maps camera-1 coordinates to
camera-2 coordinates, so ``E = [t]x R`` with ``x2^T E x1 = 0`` on
normalized image points.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class TwoViewInit(NamedTuple):
    r: jax.Array          # (3, 3) relative rotation cam1 -> cam2
    t: jax.Array          # (3,) unit-norm relative translation
    depths1: jax.Array    # (N,) triangulated depths in camera-1 frame
    good: jax.Array       # (N,) bool: positive depth in both cameras
    n_good: jax.Array     # () int32 cheirality vote of the winner


def normalize_pixels(uv: jax.Array, intrinsics: jax.Array) -> jax.Array:
    """(N, 2) pixel coords -> (N, 2) normalized camera coords."""
    fx, fy, cx, cy = intrinsics
    return jnp.stack(
        [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], axis=1
    )


def essential_from_correspondences(
    x1: jax.Array, x2: jax.Array, weights: jax.Array
) -> jax.Array:
    """Weighted 8-point essential matrix from normalized correspondences.

    Builds the (N, 9) epipolar constraint matrix A (rows weighted), takes
    the eigenvector of A^T A with the smallest eigenvalue (9x9 ``eigh`` —
    cheap, jit-friendly, no data-dependent shapes), then projects onto
    the essential manifold (singular values -> (s, s, 0)).
    """
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    # x2^T E x1 = 0, E row-major: a = [u2u1, u2v1, u2, v2u1, v2v1, v2, u1, v1, 1]
    a = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=1
    )
    a = a * weights[:, None]
    ata = a.T @ a
    _, vecs = jnp.linalg.eigh(ata)  # ascending eigenvalues
    e = vecs[:, 0].reshape(3, 3)
    # Project to the essential manifold.
    uu, ss, vt = jnp.linalg.svd(e)
    s = 0.5 * (ss[0] + ss[1])
    return (uu * jnp.asarray([s, s, 0.0])) @ vt


def sampson_residuals(
    e: jax.Array, x1: jax.Array, x2: jax.Array
) -> jax.Array:
    """First-order geometric (Sampson) epipolar residual per match."""
    h1 = jnp.concatenate([x1, jnp.ones((x1.shape[0], 1), x1.dtype)], axis=1)
    h2 = jnp.concatenate([x2, jnp.ones((x2.shape[0], 1), x2.dtype)], axis=1)
    ex1 = h1 @ e.T          # (N, 3) rows E x1
    etx2 = h2 @ e           # (N, 3) rows E^T x2
    num = jnp.sum(h2 * ex1, axis=1)
    den = (
        ex1[:, 0] ** 2 + ex1[:, 1] ** 2
        + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
    )
    return num / jnp.sqrt(jnp.maximum(den, 1e-18))


def _hartley_transform(x: jax.Array, w: jax.Array) -> jax.Array:
    """(3, 3) similarity moving weighted centroid to 0, RMS radius to
    sqrt(2) — the conditioning that makes the 8-point estimator usable
    at small baselines (without it, the unit homogeneous coordinate
    dominates the constraint matrix and LS collapses toward a spurious
    forward-motion epipole under realistic track noise)."""
    wn = w / jnp.maximum(w.sum(), 1e-6)
    c = jnp.sum(x * wn[:, None], axis=0)
    d = x - c
    rms = jnp.sqrt(jnp.sum(wn * jnp.sum(d * d, axis=1)) + 1e-18)
    s = jnp.sqrt(2.0) / jnp.maximum(rms, 1e-9)
    return jnp.asarray(
        [[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]],
        x.dtype,
    )


def _fundamental_ls(
    x1: jax.Array, x2: jax.Array, weights: jax.Array
) -> jax.Array:
    """Rank-2-projected LS fundamental matrix (same constraint rows as
    ``essential_from_correspondences`` but without the essential
    singular-value constraint — used in Hartley-normalized space where
    the essential structure does not hold)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    a = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=1
    )
    a = a * weights[:, None]
    _, vecs = jnp.linalg.eigh(a.T @ a)
    f = vecs[:, 0].reshape(3, 3)
    uu, ss, vt = jnp.linalg.svd(f)
    return (uu * ss.at[2].set(0.0)) @ vt


def essential_irls(
    x1: jax.Array,
    x2: jax.Array,
    valid: jax.Array,
    iterations: int = 6,
) -> jax.Array:
    """Robust essential estimation: Hartley-normalized 8-point +
    Cauchy-IRLS on Sampson residuals.

    The plain least-squares 8-point collapses under realistic flow-track
    noise (at small baselines the recovered translation flips to the
    forward direction); Hartley conditioning plus a few re-weighted
    rounds with a MAD-scaled Cauchy weight recover it. Fixed iteration
    count and fixed shapes: jits to one program, no RANSAC-style
    data-dependent control flow (gross outliers are handled upstream by
    forward-backward track culling plus the down-weighting here).
    """
    w0 = valid.astype(x1.dtype)
    t1 = _hartley_transform(x1, w0)
    t2 = _hartley_transform(x2, w0)
    x1n = x1 * t1[0, 0] + t1[:2, 2]
    x2n = x2 * t2[0, 0] + t2[:2, 2]

    def estimate(w):
        fn = _fundamental_ls(x1n, x2n, jnp.sqrt(w))
        return t2.T @ fn @ t1  # back to camera-normalized coordinates

    w = w0 / jnp.maximum(w0.sum(), 1.0)
    f = estimate(w)
    for _ in range(iterations):
        r = sampson_residuals(f, x1, x2)
        # Robust scale: 1.4826 * weighted mean |r| as a cheap MAD proxy
        # (jnp.median has no mask support; mean-abs is fine for a scale).
        sigma = 1.4826 * jnp.sum(w0 * jnp.abs(r)) / jnp.maximum(
            w0.sum(), 1.0
        )
        sigma = jnp.maximum(sigma, 1e-8)
        cauchy = 1.0 / (1.0 + (r / (2.0 * sigma)) ** 2)
        wi = w0 * cauchy
        wi = wi / jnp.maximum(wi.sum(), 1e-6)
        f = estimate(wi)

    # Final projection onto the essential manifold.
    uu, ss, vt = jnp.linalg.svd(f)
    s = 0.5 * (ss[0] + ss[1])
    return (uu * jnp.asarray([s, s, 0.0])) @ vt


def decompose_essential(e: jax.Array) -> tuple[jax.Array, jax.Array]:
    """E -> 4 candidate (R, t): (4, 3, 3) rotations, (4, 3) unit t."""
    uu, _, vt = jnp.linalg.svd(e)
    # Keep det(U), det(V) = +1 so the candidates are proper rotations.
    uu = uu * jnp.sign(jnp.linalg.det(uu))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    w = jnp.asarray(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e.dtype
    )
    r1 = uu @ w @ vt
    r2 = uu @ w.T @ vt
    t = uu[:, 2]
    rs = jnp.stack([r1, r1, r2, r2])
    ts = jnp.stack([t, -t, t, -t])
    return rs, ts


def triangulate(
    r: jax.Array, t: jax.Array, x1: jax.Array, x2: jax.Array
) -> jax.Array:
    """Two-view linear (midpoint) triangulation in camera-1 coordinates.

    Rays: camera 1 through ``(x1, 1)`` from the origin; camera 2 through
    ``R^T (x2, 1)`` from center ``c2 = -R^T t``. Solves the 2x2 normal
    equations of ``min |o1 + a d1 - (o2 + b d2)|`` per point (batched,
    closed form — no per-point SVD), returns the midpoint. Degenerate
    (near-parallel) rays yield large/ill depths; callers gate on parallax
    or depth positivity.
    """
    d1 = jnp.concatenate([x1, jnp.ones((x1.shape[0], 1), x1.dtype)], axis=1)
    d2 = jnp.concatenate([x2, jnp.ones((x2.shape[0], 1), x2.dtype)], axis=1)
    d2 = d2 @ r  # rows: R^T d2
    c2 = -(r.T @ t)

    a11 = jnp.sum(d1 * d1, axis=1)
    a22 = jnp.sum(d2 * d2, axis=1)
    a12 = -jnp.sum(d1 * d2, axis=1)
    rhs1 = d1 @ c2
    rhs2 = -(d2 @ c2)
    det = a11 * a22 - a12 * a12
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    alpha = (rhs1 * a22 - a12 * rhs2) / det
    beta = (a11 * rhs2 - a12 * rhs1) / det
    p1 = alpha[:, None] * d1
    p2 = c2 + beta[:, None] * d2
    return 0.5 * (p1 + p2)


@jax.jit
def two_view_init(
    uv1: jax.Array,
    uv2: jax.Array,
    valid: jax.Array,
    intrinsics: jax.Array,
) -> TwoViewInit:
    """Closed-form relative pose from matched pixel observations.

    Fixed-shape (invalid rows carry zero weight), fully jitted: 8-point
    essential matrix, 4-way decomposition, cheirality vote (the candidate
    placing the most points in front of BOTH cameras wins — the JAX
    replacement for RANSAC hypothesis selection; outlier robustness comes
    from the caller's forward-backward track culling).
    """
    # Tiny-matrix geometry: reduced default matmul precision (TF32 on a
    # GPU) breaks rotation orthonormality at the 1e-3 level — force
    # full f32.
    with jax.default_matmul_precision("highest"):
        x1 = normalize_pixels(uv1, intrinsics)
        x2 = normalize_pixels(uv2, intrinsics)
        e = essential_irls(x1, x2, valid)
        rs, ts = decompose_essential(e)

        def score(r, t):
            p1 = triangulate(r, t, x1, x2)
            z1 = p1[:, 2]
            z2 = (p1 @ r.T + t)[:, 2]
            good = (z1 > 1e-6) & (z2 > 1e-6) & valid
            return good.sum(), p1, good

        votes, p1s, goods = jax.vmap(score)(rs, ts)
        best = jnp.argmax(votes)
        return TwoViewInit(
            r=rs[best],
            t=ts[best],
            depths1=p1s[best][:, 2],
            good=goods[best],
            n_good=votes[best].astype(jnp.int32),
        )


@functools.partial(jax.jit, static_argnames=("n_landmarks",))
def triangulate_landmarks(
    poses_r: jax.Array,      # (K, 3, 3) world->camera
    poses_t: jax.Array,      # (K, 3)
    obs_uv: jax.Array,       # (N, 2)
    obs_cam: jax.Array,      # (N,) int32
    obs_lm: jax.Array,       # (N,) int32
    obs_valid: jax.Array,    # (N,) bool
    intrinsics: jax.Array,
    n_landmarks: int,
    fallback: jax.Array,     # (M, 3) used where triangulation is degenerate
) -> jax.Array:
    """Multi-view linear triangulation of every landmark (world frame).

    Each valid observation contributes the two DLT rows of
    ``x (P3 . X) - (P1 . X) = 0`` / ``y (P3 . X) - (P2 . X) = 0`` to its
    landmark's 3x3 (+rhs) normal system (segment-summed — fixed shapes,
    accelerator-friendly). Landmarks whose system is near-singular (single view /
    no parallax) or that land behind any observing camera fall back to
    ``fallback``.
    """
    with jax.default_matmul_precision("highest"):
        return _triangulate_landmarks(
            poses_r, poses_t, obs_uv, obs_cam, obs_lm, obs_valid,
            intrinsics, n_landmarks, fallback,
        )


def _triangulate_landmarks(
    poses_r, poses_t, obs_uv, obs_cam, obs_lm, obs_valid, intrinsics,
    n_landmarks, fallback,
):
    x = normalize_pixels(obs_uv, intrinsics)
    r = poses_r[obs_cam]           # (N, 3, 3)
    t = poses_t[obs_cam]           # (N, 3)
    # Rows of [x*P3 - P1; y*P3 - P2] for P = [R | t]: coefficients on X
    # and the constant term.
    row1 = x[:, 0:1] * r[:, 2] - r[:, 0]     # (N, 3)
    row2 = x[:, 1:2] * r[:, 2] - r[:, 1]
    c1 = x[:, 0] * t[:, 2] - t[:, 0]         # (N,)
    c2 = x[:, 1] * t[:, 2] - t[:, 1]
    w = obs_valid.astype(x.dtype)[:, None]

    def outer(rows, c):
        return (
            rows[:, :, None] * rows[:, None, :] * w[:, :, None],
            -rows * c[:, None] * w,
        )

    a1, b1 = outer(row1, c1)
    a2, b2 = outer(row2, c2)
    ata = jnp.zeros((n_landmarks, 3, 3)).at[obs_lm].add(a1 + a2)
    atb = jnp.zeros((n_landmarks, 3)).at[obs_lm].add(b1 + b2)

    # Solvability: smallest eigenvalue of the 3x3 system bounded away
    # from zero relative to its trace (two-view parallax signal).
    evals = jnp.linalg.eigvalsh(ata)
    ok = evals[:, 0] > 1e-4 * jnp.maximum(evals[:, 2], 1e-12)
    sol = jnp.linalg.solve(
        ata + 1e-9 * jnp.eye(3)[None], atb[:, :, None]
    )[:, :, 0]

    # Cheirality per observation -> all observing cameras must see z > 0.
    z_obs = jnp.einsum("nj,nj->n", r[:, 2], sol[obs_lm]) + t[:, 2]
    bad_obs = (z_obs <= 1e-3) & obs_valid
    n_bad = jnp.zeros(n_landmarks).at[obs_lm].add(bad_obs.astype(x.dtype))
    ok = ok & (n_bad == 0) & jnp.all(jnp.isfinite(sol), axis=1)
    return jnp.where(ok[:, None], sol, fallback)
