"""Micro-tests: tpuflow.core.ops vs SciPy golden semantics.

These pin the exact boundary/sampling behaviors the accuracy-parity gate
depends on (SURVEY.md §7 'Hard parts'): convolve2d kernel flip +
boundary='symm', gaussian_filter truncation/boundary, map_coordinates
order=1 constant-mode edge semantics, linspace resampling grids.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy import signal
from scipy.ndimage import gaussian_filter as sp_gauss
from scipy.ndimage import map_coordinates

from tpuflow.core import ops
from tpuflow.kernels import jnp_ref


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(7).uniform(0.0, 255.0, (57, 83)).astype(np.float32)


def test_conv2d_symm_matches_convolve2d(img):
    for kernel in (jnp_ref.SOBEL_X, jnp_ref.SOBEL_Y):
        ref = signal.convolve2d(img, kernel, mode="same", boundary="symm")
        got = np.asarray(ops.conv2d_symm(jnp.asarray(img), kernel))
        assert ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_conv2d_symm_is_true_convolution():
    # An asymmetric kernel distinguishes convolution from correlation.
    k = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    img = np.zeros((7, 7), np.float32)
    img[3, 3] = 1.0
    ref = signal.convolve2d(img, k, mode="same", boundary="symm")
    got = np.asarray(ops.conv2d_symm(jnp.asarray(img), k))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_gaussian_filter_matches_scipy(img):
    for sigma in (1.0, 2.0):
        ref = sp_gauss(img, sigma=sigma)
        got = np.asarray(ops.gaussian_filter(jnp.asarray(img), sigma))
        np.testing.assert_allclose(got, ref, atol=1e-3)


def test_gaussian_kernel_radius():
    # scipy radius = int(truncate * sigma + 0.5): 8 taps each side at sigma=2.
    assert len(ops.gaussian_kernel1d(2.0)) == 17
    assert len(ops.gaussian_kernel1d(1.0)) == 9


def test_map_coordinates_interior(img, rng):
    h, w = img.shape
    y = rng.uniform(0, h - 1, (200,))
    x = rng.uniform(0, w - 1, (200,))
    ref = map_coordinates(img, [y, x], order=1, mode="constant")
    got = np.asarray(
        ops.map_coordinates_bilinear(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x))
    )
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_map_coordinates_oob_is_hard_cval(img):
    # SciPy 'constant' mode: ANY coordinate fractionally outside [0, N-1]
    # returns cval outright — no blending with border pixels.
    h, w = img.shape
    y = np.array([-0.3, -0.001, 0.0, h - 1.0, h - 0.999, h + 2.0, 5.0, 5.0])
    x = np.array([5.0, 5.0, 5.0, 5.0, 5.0, 5.0, -0.4, w - 0.5])
    ref = map_coordinates(img, [y, x], order=1, mode="constant")
    got = np.asarray(
        ops.map_coordinates_bilinear(jnp.asarray(img), jnp.asarray(y), jnp.asarray(x))
    )
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_resize_bilinear_matches_linspace_map_coordinates(img):
    h, w = img.shape
    for nh, nw in ((28, 41), (114, 166)):
        yc = np.linspace(0, h - 1, nh)
        xc = np.linspace(0, w - 1, nw)
        yy, xx = np.meshgrid(yc, xc, indexing="ij")
        ref = map_coordinates(img, [yy, xx], order=1, mode="constant")
        got = np.asarray(ops.resize_bilinear(jnp.asarray(img), nh, nw))
        np.testing.assert_allclose(got, ref, atol=1e-3)


def test_uniform_window_sum(img):
    ref = signal.convolve2d(img, np.ones((5, 5), np.float32), mode="valid")
    got = np.asarray(ops.uniform_window_sum_valid(jnp.asarray(img), 5))
    assert got.shape == (img.shape[0] - 4, img.shape[1] - 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_banded_resample_properties():
    """The block-banded matmul resample (ops._banded_left/_banded_right):
    (a) suite-resolution outputs (<= _BAND_BLOCK) take the dense branch
    and are bit-identical to the plain matrix product — every parity and
    committed-baseline path is unchanged; (b) large outputs agree with
    the dense product to the documented ~1-ulp FMA-contraction class."""
    import jax
    import jax.numpy as jnp

    from tpuflow.core import ops

    rng = np.random.default_rng(3)

    def dense_resize(img, oh, ow):
        wr = jnp.asarray(ops._resample_matrix_np(img.shape[0], oh), jnp.float32)
        wc = jnp.asarray(ops._resample_matrix_np(img.shape[1], ow), jnp.float32)
        out = jax.lax.dot(wr, img, precision=jax.lax.Precision.HIGHEST)
        return jax.lax.dot(out, wc.T, precision=jax.lax.Precision.HIGHEST)

    # (a) suite resolution: bit-identical (dense branch).
    img = jnp.asarray(rng.uniform(0, 255, (240, 320)), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(ops.resize_bilinear(img, 120, 160)),
        np.asarray(dense_resize(img, 120, 160)),
    )
    # (b) 1080p: banded branch, <= 2 ulp of the dense product.
    big = jnp.asarray(rng.uniform(0, 255, (1080, 1920)), jnp.float32)
    got = np.asarray(ops.resize_bilinear(big, 540, 960))
    ref = np.asarray(dense_resize(big, 540, 960))
    assert np.abs(got - ref).max() <= 2 * 3.05e-5

    # downsample: same structure, Gaussian band.
    got_d = np.asarray(ops.downsample_fused(big, 540, 960, 2.0))
    dr = jnp.asarray(ops._downsample_matrix_np(1080, 540, 2.0), jnp.float32)
    dc = jnp.asarray(ops._downsample_matrix_np(1920, 960, 2.0), jnp.float32)
    ref_d = np.asarray(
        jax.lax.dot(
            jax.lax.dot(dr, big, precision=jax.lax.Precision.HIGHEST),
            dc.T, precision=jax.lax.Precision.HIGHEST,
        )
    )
    assert np.abs(got_d - ref_d).max() < 1e-3  # ~ulp scale on 0..255

    # Block decomposition covers every output row exactly once and only
    # touches in-range columns.
    d_np = ops._downsample_matrix_np(2160, 1080, 2.0)
    blocks = ops._banded_blocks(d_np, ops._BAND_BLOCK)
    assert blocks[0][0] == 0 and blocks[-1][1] == 1080
    for (b0, b1, lo, hi), (n0, _, _, _) in zip(blocks, blocks[1:]):
        assert b1 == n0
    for b0, b1, lo, hi in blocks:
        assert 0 <= lo < hi <= 2160
        # nothing nonzero outside [lo, hi)
        outside = np.abs(d_np[b0:b1, :lo]).sum() + np.abs(d_np[b0:b1, hi:]).sum()
        assert outside == 0.0
