"""Pure-jnp reference kernels for Lucas-Kanade dense flow.

These are the numerical ground truth inside this framework: every Pallas
kernel has a twin here and is equivalence-tested against it. They
vectorize the reference golden model's per-pixel loops into whole-array
XLA ops (the reference's hot loop is a Python double loop over ~75k
pixels, python/lucas_kanade_core.py:107-133; here it is one fused tensor
expression).

Semantics intentionally matched to the reference:

- Sobel/8 on the averaged frame, true convolution, symmetric boundary
  (python/lucas_kanade_core.py:31-40).
- It = prev - curr (python/lucas_kanade_core.py:43).
- Unweighted window sums over fully-interior windows only; border flow 0
  (python/lucas_kanade_core.py:104-119).
- Cramer solve gated on |det| > 1e-4 (python/lucas_kanade_core.py:128-133).
- Warp / pyramid resampling via bilinear map_coordinates semantics
  (python/lucas_kanade_pyramidal.py:23-138).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tpuflow.core import ops

SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32) / 8.0
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float32) / 8.0


def compute_gradients(
    frame_prev: jax.Array, frame_curr: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Spatial Sobel gradients of the averaged frame + temporal difference.

    Twin of reference python/lucas_kanade_core.py:15-45.
    """
    frame_avg = (frame_prev + frame_curr) / 2.0
    ix = ops.conv2d_symm(frame_avg, SOBEL_X)
    iy = ops.conv2d_symm(frame_avg, SOBEL_Y)
    it = frame_prev - frame_curr
    return ix, iy, it


def lucas_kanade_from_gradients(
    ix: jax.Array,
    iy: jax.Array,
    it: jax.Array,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    weight_sigma: float = 1.0,
    return_confidence: bool = False,
):
    """Windowed least-squares flow solve (structure tensor + Cramer).

    Twin of reference python/lucas_kanade_core.py:73-135. Flow is zero at
    the ``window//2`` border and wherever ``|det| <= det_threshold``.

    ``gaussian_weights`` enables the Gaussian window weighting the
    reference documents but does not implement (README.md:126-129) —
    off by default to match the committed baselines.

    ``return_confidence`` additionally returns |det| of the structure
    tensor (zero on the border) — the texture/conditioning measure the
    det gate already evaluates; downstream consumers (e.g. track
    weighting) get it for free instead of recomputing window sums.
    """
    half = window_size // 2

    if gaussian_weights:
        wk = ops.gaussian_window_kernel(window_size, weight_sigma)
        wsum = lambda a: ops.weighted_window_sum_valid(a, wk)  # noqa: E731
    else:
        wsum = lambda a: ops.uniform_window_sum_valid(a, window_size)  # noqa: E731

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    s_xt = wsum(ix * it)
    s_yt = wsum(iy * it)

    det = s_xx * s_yy - s_xy * s_xy
    b0 = -s_xt
    b1 = -s_yt

    solvable = jnp.abs(det) > det_threshold
    safe_det = jnp.where(solvable, det, 1.0)
    u_in = jnp.where(solvable, (s_yy * b0 - s_xy * b1) / safe_det, 0.0)
    v_in = jnp.where(solvable, (s_xx * b1 - s_xy * b0) / safe_det, 0.0)

    pad = ((half, half), (half, half))
    u = jnp.pad(u_in, pad)
    v = jnp.pad(v_in, pad)
    if return_confidence:
        return u, v, jnp.pad(jnp.abs(det), pad)
    return u, v


def warp_image(image: jax.Array, flow_u: jax.Array, flow_v: jax.Array) -> jax.Array:
    """Bilinear backward warp: out(x, y) = image(x + u, y + v), OOB -> 0.

    Twin of reference python/lucas_kanade_pyramidal.py:66-97.
    """
    h, w = image.shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return ops.map_coordinates_bilinear(image, yy + flow_v, xx + flow_u, cval=0.0)


def clamp_flow(
    flow_u: jax.Array, flow_v: jax.Array, max_disp: float, max_disp_v: float
) -> tuple[jax.Array, jax.Array]:
    """Saturate flow at +-max_disp (vertically +-max_disp_v): the fast
    path's analog of the RTL solver clamp (rtl/unopt/flow_solver.sv:
    134-144). The golden model never clamps."""
    return (
        jnp.clip(flow_u, -max_disp, max_disp),
        jnp.clip(flow_v, -max_disp_v, max_disp_v),
    )


def upsample_flow(
    flow_u: jax.Array, flow_v: jax.Array, target_shape: tuple[int, int]
) -> tuple[jax.Array, jax.Array]:
    """Bilinear flow upsampling with magnitude rescaling.

    Twin of reference python/lucas_kanade_pyramidal.py:100-138: resample on
    the ``linspace(0, coarse-1, fine)`` grid, then scale u by
    ``fine_w/coarse_w`` and v by ``fine_h/coarse_h``.
    """
    ch, cw = flow_u.shape
    th, tw = target_shape
    scale_x = tw / cw
    scale_y = th / ch
    u = ops.resize_bilinear(flow_u, th, tw) * scale_x
    v = ops.resize_bilinear(flow_v, th, tw) * scale_y
    return u, v


def downsample_image(image: jax.Array, scale_factor: float = 0.5) -> jax.Array:
    """One pyramid downsampling step: Gaussian smooth then bilinear resample.

    Twin of reference python/lucas_kanade_pyramidal.py:44-59: sigma =
    1/scale_factor, new dims = int(dim * scale_factor), resample on the
    linspace grid (NOT area averaging, NOT jax.image.resize defaults).
    Runs as the composed per-axis operator, one matmul per axis
    (ops.downsample_fused) — same linear map, f32-rounding-equivalent to
    smoothing then resampling sequentially.
    """
    sigma = 1.0 / scale_factor
    h, w = image.shape
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    return ops.downsample_fused(image, nh, nw, sigma)


def build_gaussian_pyramid(
    image: jax.Array, num_levels: int, scale_factor: float = 0.5
) -> list[jax.Array]:
    """Gaussian pyramid, list ordered coarse -> fine (level 0 = coarsest).

    Twin of reference python/lucas_kanade_pyramidal.py:23-63.
    """
    levels = [image]
    current = image
    for _ in range(num_levels - 1):
        current = downsample_image(current, scale_factor)
        levels.append(current)
    levels.reverse()
    return levels
