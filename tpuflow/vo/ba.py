"""Bundle adjustment with Schur-complement reduction, in JAX.

The BA back-end the BASELINE.json north star mandates (no reference
counterpart — the reference stops at dense flow). Design:

- Fixed-size observation table (obs_uv, obs_cam, obs_lm, obs_valid) so
  the whole Gauss-Newton step jits; dead observations carry zero weight.
- Analytic-free Jacobians: per-observation (2x6, 2x3) blocks via
  ``jax.jacfwd`` of the residual at the identity tangent — exact, fused
  by XLA, and batched with ``vmap`` (the replacement for hand-derived
  BA Jacobian code).
- Schur complement: landmark blocks are 3x3 (closed-form inverse); the
  reduced camera system S = H_pp - B H_ll^-1 B^T is assembled with
  einsums, then solved densely (6K x 6K for K
  keyframes — small).
- Distribution: shard the observation table across devices/hosts; every
  per-observation accumulation (H_pp, H_ll, B, b) is a local
  segment-sum followed by ``lax.psum`` over ``axis_name`` — the
  "allreduce for the reduced camera system" across devices and hosts.
  The dense solve is replicated (tiny).

Gauge freedom is fixed with a strong prior on camera 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.vo import se3
from tpuflow.vo._precision import pin_matmul_precision


class BAProblem(NamedTuple):
    poses_r: jax.Array    # (K, 3, 3)
    poses_t: jax.Array    # (K, 3)
    landmarks: jax.Array  # (M, 3)
    obs_uv: jax.Array     # (N, 2) pixel observations
    obs_cam: jax.Array    # (N,) int32 camera index
    obs_lm: jax.Array     # (N,) int32 landmark index
    obs_valid: jax.Array  # (N,) bool
    intrinsics: jax.Array  # (4,) = (fx, fy, cx, cy)


def project(r, t, p, intrinsics):
    """Pinhole projection of world point p under camera (R, t)."""
    pc = r @ p + t
    fx, fy, cx, cy = intrinsics
    z = jnp.maximum(pc[2], 1e-6)
    return jnp.stack([fx * pc[0] / z + cx, fy * pc[1] / z + cy])


def _residual(xi, dl, r, t, lm, uv, intrinsics):
    """Reprojection residual at a tangent perturbation (xi, dl)."""
    rr, tt = se3.retract(r, t, xi)
    return project(rr, tt, lm + dl, intrinsics) - uv


def reprojection_errors(p: BAProblem) -> jax.Array:
    """(N,) residual norms (invalid observations read 0)."""
    def one(cam, lm_i, uv):
        pred = project(p.poses_r[cam], p.poses_t[cam], p.landmarks[lm_i],
                       p.intrinsics)
        return jnp.linalg.norm(pred - uv)

    # Exact f32: a GPU's default matmul precision may run TF32, which
    # perturbs the GN iteration path enough to break cross-platform
    # baseline comparison (vs the CPU-captured vo_baseline.json). The
    # matrices here are tiny; HIGHEST costs nothing.
    with jax.default_matmul_precision("highest"):
        e = jax.vmap(one)(p.obs_cam, p.obs_lm, p.obs_uv)
    return jnp.where(p.obs_valid, e, 0.0)


def _obs_blocks(p: BAProblem, huber_delta: float):
    """Per-observation residuals, Jacobians, and robust weights.

    Weight = Huber down to ``huber_delta``, hard zero beyond 25x it
    (gross outliers would otherwise drag their landmarks through the
    camera plane), and zero for observations whose landmark sits at or
    behind the camera (cheirality gate).
    """
    zero6 = jnp.zeros(6)
    zero3 = jnp.zeros(3)

    def one(cam, lm_i, uv):
        r = p.poses_r[cam]
        t = p.poses_t[cam]
        lm = p.landmarks[lm_i]
        res = _residual(zero6, zero3, r, t, lm, uv, p.intrinsics)
        jp = jax.jacfwd(_residual, argnums=0)(zero6, zero3, r, t, lm, uv,
                                              p.intrinsics)
        jl = jax.jacfwd(_residual, argnums=1)(zero6, zero3, r, t, lm, uv,
                                              p.intrinsics)
        depth = (r @ lm + t)[2]
        return res, jp, jl, depth

    res, jp, jl, depth = jax.vmap(one)(p.obs_cam, p.obs_lm, p.obs_uv)
    norm = jnp.linalg.norm(res, axis=1)
    huber = jnp.where(norm <= huber_delta, 1.0, huber_delta / (norm + 1e-12))
    w = jnp.where(p.obs_valid, huber, 0.0)
    w = jnp.where(norm > 25.0 * huber_delta, 0.0, w)
    w = jnp.where(depth > 1e-2, w, 0.0)
    return res, jp, jl, w


def _inv3(m):
    """Closed-form batched 3x3 inverse (landmark blocks)."""
    return jnp.linalg.inv(m)


@functools.partial(
    jax.jit, static_argnames=("axis_name", "num_cams", "num_lms", "fixed_cams")
)
@pin_matmul_precision
def gauss_newton_step(
    p: BAProblem,
    damping: float = 1e-4,
    huber_delta: float = 4.0,
    axis_name: str | None = None,
    num_cams: int | None = None,
    num_lms: int | None = None,
    fixed_cams: tuple[int, ...] = (0,),
) -> BAProblem:
    """One damped Gauss-Newton step with Schur-complement reduction.

    With ``axis_name`` set (inside shard_map/pjit over sharded
    observations), partial normal-equation blocks are psum-reduced
    before the replicated dense solve.

    ``fixed_cams``: cameras pinned by a strong prior. Monocular BA has a
    7-DOF gauge (pose of one camera + global scale); pin two cameras —
    or one camera plus external scale — for a fully determined system.
    """
    k = num_cams or p.poses_r.shape[0]
    m = num_lms or p.landmarks.shape[0]

    res, jp, jl, w = _obs_blocks(p, huber_delta)
    wr = w[:, None]

    # Per-observation normal-equation blocks (isotropic robust weight).
    hpp_o = jnp.einsum("nia,nib->nab", jp, jp) * w[:, None, None]
    hll_o = jnp.einsum("nia,nib->nab", jl, jl) * w[:, None, None]
    hpl_o = jnp.einsum("nia,nib->nab", jp, jl) * w[:, None, None]
    bp_o = -jnp.einsum("nia,ni->na", jp, res * wr)
    bl_o = -jnp.einsum("nia,ni->na", jl, res * wr)

    # Scatter to per-camera / per-landmark / per-(landmark, camera) sums.
    hpp = jnp.zeros((k, 6, 6)).at[p.obs_cam].add(hpp_o)
    hll = jnp.zeros((m, 3, 3)).at[p.obs_lm].add(hll_o)
    b_blocks = jnp.zeros((m, k, 6, 3)).at[p.obs_lm, p.obs_cam].add(hpl_o)
    bp = jnp.zeros((k, 6)).at[p.obs_cam].add(bp_o)
    bl = jnp.zeros((m, 3)).at[p.obs_lm].add(bl_o)

    if axis_name is not None:
        hpp = jax.lax.psum(hpp, axis_name)
        hll = jax.lax.psum(hll, axis_name)
        b_blocks = jax.lax.psum(b_blocks, axis_name)
        bp = jax.lax.psum(bp, axis_name)
        bl = jax.lax.psum(bl, axis_name)

    # Levenberg-style relative damping (scales with the problem, so
    # degenerate geometry — e.g. a single plane — stays solvable) plus a
    # small absolute floor for empty blocks.
    def damp(h):
        d = jnp.einsum("...ii->...i", h)
        return h + jnp.vectorize(jnp.diag, signature="(n)->(n,n)")(
            damping * d + 1e-6
        )

    hll = damp(hll)
    hpp = damp(hpp)

    hll_inv = _inv3(hll)

    # Reduced camera system (einsums over landmark blocks):
    # S = blockdiag(H_pp) - sum_m B_m H_ll,m^-1 B_m^T
    s = jnp.zeros((k, 6, k, 6))
    s = s.at[jnp.arange(k), :, jnp.arange(k), :].set(hpp)
    s = s - jnp.einsum("mkab,mbc,mldc->kald", b_blocks, hll_inv, b_blocks)
    rhs = bp - jnp.einsum("mkab,mbc,mc->ka", b_blocks, hll_inv, bl)

    # Gauge fixing by exact elimination (numerically far better
    # conditioned than a large prior): fixed cameras get dx = 0.
    for c in fixed_cams:
        s = s.at[c].set(0.0).at[:, :, c].set(0.0)
        s = s.at[c, :, c, :].set(jnp.eye(6))
        rhs = rhs.at[c].set(0.0)

    # Jacobi-preconditioned dense solve: the raw reduced system spans
    # ~f^2 dynamic range in f32; symmetric diagonal scaling keeps the
    # factorization well conditioned.
    s2 = s.reshape(6 * k, 6 * k)
    d = jax.lax.rsqrt(jnp.clip(jnp.diagonal(s2), 1e-12, None))
    s2 = s2 * d[:, None] * d[None, :]
    y = jnp.linalg.solve(s2, rhs.reshape(6 * k) * d)
    dxp = (y * d).reshape(k, 6)

    # Back-substitute landmarks: dx_l = H_ll^-1 (b_l - B^T dx_p).
    bt_dxp = jnp.einsum("mkab,ka->mb", b_blocks, dxp)
    dxl = jnp.einsum("mbc,mc->mb", hll_inv, bl - bt_dxp)

    new_r, new_t = jax.vmap(se3.retract)(p.poses_r, p.poses_t, dxp)
    return p._replace(
        poses_r=new_r, poses_t=new_t, landmarks=p.landmarks + dxl
    )


def _robust_cost(p: BAProblem, huber_delta: float) -> float:
    """Huber-robustified total reprojection cost over valid obs."""
    e = reprojection_errors(p)
    valid = p.obs_valid
    quad = 0.5 * e * e
    lin = huber_delta * (e - 0.5 * huber_delta)
    c = jnp.where(e <= huber_delta, quad, lin)
    return float(jnp.where(valid, c, 0.0).sum())


def solve(
    p: BAProblem,
    iterations: int = 10,
    damping: float = 1e-4,
    huber_delta: float = 4.0,
    axis_name: str | None = None,
    fixed_cams: tuple[int, ...] = (0,),
    adaptive: bool = True,
) -> BAProblem:
    """Run ``iterations`` damped Gauss-Newton steps.

    With ``adaptive`` (Levenberg-Marquardt schedule, host-driven): a step
    that increases the robust cost is rejected and retried with 10x
    damping; accepted steps decay damping 3x. This keeps large-baseline
    initializations (first GN steps far outside the quadratic basin)
    from diverging. Set ``adaptive=False`` for the fixed-damping static
    loop (one XLA program when chained under jit, e.g. inside shard_map).
    """
    if not adaptive:
        for _ in range(iterations):
            p = gauss_newton_step(
                p,
                damping=damping,
                huber_delta=huber_delta,
                axis_name=axis_name,
                fixed_cams=fixed_cams,
            )
        return p

    lam = damping
    cost = _robust_cost(p, huber_delta)
    for _ in range(iterations):
        trial = gauss_newton_step(
            p,
            damping=lam,
            huber_delta=huber_delta,
            axis_name=axis_name,
            fixed_cams=fixed_cams,
        )
        trial_cost = _robust_cost(trial, huber_delta)
        if trial_cost <= cost or not np.isfinite(cost):
            p, cost = trial, trial_cost
            lam = max(lam / 3.0, 1e-8)
        else:
            lam = min(lam * 10.0, 1e4)
    return p
