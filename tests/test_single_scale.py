"""Single-scale LK vs an independent per-pixel golden implementation.

The golden below mirrors the textbook algorithm the reference golden
model implements (python/lucas_kanade_core.py:73-135): per-pixel 5x5
window sums of gradient products, Cramer solve gated on |det| > 1e-4,
zero flow on the border. Written loop-style so it shares no code path
with the vectorized implementation under test.
"""

import numpy as np
import jax.numpy as jnp
from scipy import signal

from tpuflow.flow import lucas_kanade_single_scale
from tpuflow.kernels import jnp_ref


def golden_lk(prev, curr, window=5, det_threshold=1e-4):
    sx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8.0
    sy = sx.T.copy()
    avg = (prev + curr) / 2.0
    ix = signal.convolve2d(avg, sx, mode="same", boundary="symm")
    iy = signal.convolve2d(avg, sy, mode="same", boundary="symm")
    it = prev - curr
    h, w = prev.shape
    u = np.zeros((h, w), np.float32)
    v = np.zeros((h, w), np.float32)
    r = window // 2
    for y in range(r, h - r):
        for x in range(r, w - r):
            wx = ix[y - r : y + r + 1, x - r : x + r + 1]
            wy = iy[y - r : y + r + 1, x - r : x + r + 1]
            wt = it[y - r : y + r + 1, x - r : x + r + 1]
            a00 = np.sum(wx * wx)
            a11 = np.sum(wy * wy)
            a01 = np.sum(wx * wy)
            b0 = -np.sum(wx * wt)
            b1 = -np.sum(wy * wt)
            det = a00 * a11 - a01 * a01
            if abs(det) > det_threshold:
                u[y, x] = (a11 * b0 - a01 * b1) / det
                v[y, x] = (a00 * b1 - a01 * b0) / det
    return u, v


def test_matches_golden_loop(small_frame_pair):
    prev, curr = small_frame_pair
    gu, gv = golden_lk(prev, curr)
    u, v = lucas_kanade_single_scale(jnp.asarray(prev), jnp.asarray(curr))
    np.testing.assert_allclose(np.asarray(u), gu, atol=5e-3)
    np.testing.assert_allclose(np.asarray(v), gv, atol=5e-3)


def test_border_is_zero(small_frame_pair):
    prev, curr = small_frame_pair
    u, v = lucas_kanade_single_scale(jnp.asarray(prev), jnp.asarray(curr))
    u, v = np.asarray(u), np.asarray(v)
    for arr in (u, v):
        assert np.all(arr[:2, :] == 0)
        assert np.all(arr[-2:, :] == 0)
        assert np.all(arr[:, :2] == 0)
        assert np.all(arr[:, -2:] == 0)


def test_identical_frames_give_zero_flow(small_frame_pair):
    prev, _ = small_frame_pair
    u, v = lucas_kanade_single_scale(jnp.asarray(prev), jnp.asarray(prev))
    assert np.all(np.asarray(u) == 0)
    assert np.all(np.asarray(v) == 0)


def test_recovers_translation_direction(small_frame_pair):
    # 1.5 px rightward shift of content => flow u should be negative-x
    # convention-consistent with the reference: It = prev - curr and the
    # shifted frame moved content +x, so recovered u ~ +1.5 in the
    # textured interior (underestimated by Sobel/8 scaling, same as the
    # reference's documented underestimate, README.md:373-384).
    prev, curr = small_frame_pair
    u, v = lucas_kanade_single_scale(jnp.asarray(prev), jnp.asarray(curr))
    interior_u = np.asarray(u)[10:-10, 10:-10]
    interior_v = np.asarray(v)[10:-10, 10:-10]
    assert interior_u.mean() > 0.3
    assert abs(interior_v.mean()) < 0.3


def test_window_size_7(small_frame_pair):
    prev, curr = small_frame_pair
    gu, gv = golden_lk(prev, curr, window=7)
    u, v = lucas_kanade_single_scale(jnp.asarray(prev), jnp.asarray(curr), 7)
    np.testing.assert_allclose(np.asarray(u), gu, atol=5e-3)
    np.testing.assert_allclose(np.asarray(v), gv, atol=5e-3)


def test_gaussian_weights_flag_changes_solution(small_frame_pair):
    prev, curr = small_frame_pair
    ix, iy, it = jnp_ref.compute_gradients(jnp.asarray(prev), jnp.asarray(curr))
    u0, _ = jnp_ref.lucas_kanade_from_gradients(ix, iy, it, gaussian_weights=False)
    u1, _ = jnp_ref.lucas_kanade_from_gradients(ix, iy, it, gaussian_weights=True)
    assert not np.allclose(np.asarray(u0), np.asarray(u1))


def test_confidence_output(frame_pair):
    """return_confidence: |det| plane, zero border, high on texture."""
    import jax.numpy as jnp

    from tpuflow.flow import lucas_kanade_single_scale
    from tpuflow.kernels import jnp_ref

    prev, curr = (jnp.asarray(f) for f in frame_pair)
    u, v, conf = lucas_kanade_single_scale(
        prev, curr, return_confidence=True
    )
    # Plain call unchanged.
    u2, v2 = lucas_kanade_single_scale(prev, curr)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))
    conf = np.asarray(conf)
    assert conf.shape == u2.shape
    assert np.all(conf >= 0)
    assert np.all(conf[:2] == 0) and np.all(conf[:, :2] == 0)  # border
    assert conf.max() > 1e3  # textured frames: strongly conditioned
    # |det| definition check against recomputed window sums.
    ix, iy, it = jnp_ref.compute_gradients(prev, curr)
    from tpuflow.core import ops

    sxx = np.asarray(ops.uniform_window_sum_valid(ix * ix, 5))
    syy = np.asarray(ops.uniform_window_sum_valid(iy * iy, 5))
    sxy = np.asarray(ops.uniform_window_sum_valid(ix * iy, 5))
    det = np.abs(sxx * syy - sxy * sxy)
    np.testing.assert_allclose(conf[2:-2, 2:-2], det, rtol=1e-5)

