"""SciPy-parity numerics, implemented in pure JAX.

The reference golden model (reference: python/lucas_kanade_core.py,
python/lucas_kanade_pyramidal.py) is built on three SciPy primitives whose
exact boundary/sampling semantics set the accuracy-parity gate:

1. ``scipy.signal.convolve2d(img, k, mode="same", boundary="symm")``
   — true convolution (kernel flipped), symmetric edge-reflect padding.
2. ``scipy.ndimage.gaussian_filter(img, sigma)``
   — separable Gaussian, radius ``int(truncate * sigma + 0.5)`` with
   ``truncate=4.0``, applied with 'reflect' (= symmetric) boundary.
3. ``scipy.ndimage.map_coordinates(img, coords, order=1, mode="constant")``
   — bilinear sampling on an input virtually extended with ``cval``; a
   sample whose 4-corner support partially leaves the array blends the
   in-bounds corners with ``cval``.

Each function here is a drop-in jnp equivalent, unit-tested against SciPy
golden outputs in tests/test_scipy_parity.py. Everything is float32 and
shape-static so it stages cleanly into XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Small-kernel 2-D correlations are computed as unrolled shifted
# multiply-adds rather than lax.conv: XLA fuses them into one
# elementwise pass, they stay exact f32 (lax.conv at default precision
# may run as TF32 on a GPU's tensor cores), and the accuracy gate is
# float32-vs-float32 within 10%.


def _corr2d_valid(x: jax.Array, k: np.ndarray | jax.Array) -> jax.Array:
    """VALID-mode 2-D correlation via unrolled static shifts, f32-exact."""
    k = np.asarray(k)
    kh, kw = k.shape
    oh, ow = x.shape[0] - kh + 1, x.shape[1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            w = float(k[i, j])
            if w == 0.0:
                continue
            term = w * jax.lax.slice(x, (i, j), (i + oh, j + ow))
            out = term if out is None else out + term
    assert out is not None
    return out


def _corr1d_valid(x: jax.Array, taps: np.ndarray, axis: int) -> jax.Array:
    """VALID-mode 1-D correlation along ``axis`` via unrolled shifts."""
    n = len(taps)
    if axis == 0:
        oh = x.shape[0] - n + 1
        out = float(taps[0]) * jax.lax.slice(x, (0, 0), (oh, x.shape[1]))
        for i in range(1, n):
            out = out + float(taps[i]) * jax.lax.slice(
                x, (i, 0), (i + oh, x.shape[1])
            )
    else:
        ow = x.shape[1] - n + 1
        out = float(taps[0]) * jax.lax.slice(x, (0, 0), (x.shape[0], ow))
        for i in range(1, n):
            out = out + float(taps[i]) * jax.lax.slice(
                x, (0, i), (x.shape[0], i + ow)
            )
    return out


def conv2d_symm(img: jax.Array, kernel: np.ndarray) -> jax.Array:
    """2-D convolution, 'same' output, symmetric boundary.

    Matches ``scipy.signal.convolve2d(img, kernel, mode="same",
    boundary="symm")`` for odd-sized kernels (reference usage:
    python/lucas_kanade_core.py:39-40). ``kernel`` must be a static numpy
    array; the flip that distinguishes convolution from correlation is
    folded into it at trace time.
    """
    kh, kw = kernel.shape
    assert kh % 2 == 1 and kw % 2 == 1, "odd kernels only"
    ph, pw = kh // 2, kw // 2
    flipped = np.ascontiguousarray(kernel[::-1, ::-1])
    padded = jnp.pad(img, ((ph, ph), (pw, pw)), mode="symmetric")
    # Correlation with the flipped kernel == true convolution.
    return _corr2d_valid(padded, flipped)


@functools.lru_cache(maxsize=None)
def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The 1-D Gaussian tap vector scipy.ndimage uses.

    Radius ``int(truncate * sigma + 0.5)``; taps ``exp(-0.5 x^2 / sigma^2)``
    normalized to sum 1 (float64, then cast at use sites). Matches
    ``scipy.ndimage._filters._gaussian_kernel1d`` output for order=0.
    """
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    phi /= phi.sum()
    return phi


def gaussian_filter(img: jax.Array, sigma: float, truncate: float = 4.0) -> jax.Array:
    """Separable Gaussian smoothing with 'reflect' (symmetric) boundary.

    Matches ``scipy.ndimage.gaussian_filter(img, sigma)`` defaults
    (reference usage: python/lucas_kanade_pyramidal.py:47 with sigma=2.0).
    The kernel is symmetric, so correlation == convolution.
    """
    taps = gaussian_kernel1d(sigma, truncate).astype(np.float32)
    r = len(taps) // 2

    padded = jnp.pad(img, ((r, r), (0, 0)), mode="symmetric")
    out = _corr1d_valid(padded, taps, axis=0)
    padded = jnp.pad(out, ((0, 0), (r, r)), mode="symmetric")
    return _corr1d_valid(padded, taps, axis=1)


def map_coordinates_bilinear(
    img: jax.Array,
    y: jax.Array,
    x: jax.Array,
    cval: float = 0.0,
    *,
    origin: tuple = (0, 0),
    bounds: tuple[int, int] | None = None,
) -> jax.Array:
    """Bilinear sampling of ``img`` at float coordinates ``(y, x)``.

    Matches ``scipy.ndimage.map_coordinates(img, [y, x], order=1,
    mode="constant", cval=cval)`` (reference usage:
    python/lucas_kanade_pyramidal.py:59,95,131-132). SciPy's 'constant'
    mode returns ``cval`` for ANY coordinate outside ``[0, N-1]`` — even
    fractionally outside; it does NOT blend border pixels with ``cval``
    (verified empirically against scipy 1.17). Samples exactly on the far
    edge (coord == N-1) interpolate with zero weight on the clamped
    out-of-range corner.

    ``img`` may be a window of a larger image: ``origin`` is the integer
    (row, col) of ``img[0, 0]`` in that image (traced values allowed)
    and ``bounds`` its (rows, cols), the ``N`` of the out-of-range test.
    ``(y, x)`` are then coordinates in the larger image, so a window
    sees the same fractional parts, and the same samples, as the whole.
    """
    h, w = img.shape
    n_y, n_x = bounds or (h, w)
    y0f = jnp.floor(y)
    x0f = jnp.floor(x)
    fy = (y - y0f).astype(img.dtype)
    fx = (x - x0f).astype(img.dtype)
    y0 = y0f.astype(jnp.int32) - origin[0]
    x0 = x0f.astype(jnp.int32) - origin[1]

    def corner(yi, xi):
        return img[jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1)]

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)

    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    val = top * (1.0 - fy) + bot * fy

    inside = (y >= 0) & (y <= n_y - 1) & (x >= 0) & (x <= n_x - 1)
    return jnp.where(inside, val, jnp.asarray(cval, img.dtype))


def linspace_grid(n_src: int, n_dst: int) -> np.ndarray:
    """``np.linspace(0, n_src - 1, n_dst)`` in float64 — the resampling grid
    used by the reference for pyramid down/upsampling (reference:
    python/lucas_kanade_pyramidal.py:55-56,126-127). Kept f64 so the
    floor/fraction split below matches SciPy's double-precision sampling."""
    return np.linspace(0.0, float(n_src - 1), n_dst)


def resize_bilinear(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Resample to (out_h, out_w) on the reference's linspace grid.

    The grid is a separable outer product, so the resample is two matrix
    products against static interpolation matrices with two nonzeros per
    row — they run as matmuls instead of gathers. A two-term dot is
    order-independent in f32, so values match
    bilinear ``map_coordinates`` on the same grid exactly (all
    coordinates in-bounds). Applied block-banded (``_banded_left/right``)
    for outputs above ``_BAND_BLOCK``: the dropped matrix tails are exact
    zeros, but XLA codegen may contract the two-term row differently at
    the different K extent (measured 1 ulp at 1080p). Reference-suite
    resolutions (<=320x240, and every parity/baseline path) stay on the
    dense branch and remain bit-identical.
    """
    h, w = img.shape
    out = _banded_left(_resample_matrix_np(h, out_h), img)
    return _banded_right(out, _resample_matrix_np(w, out_w))


def downsample_fused(
    img: jax.Array, out_h: int, out_w: int, sigma: float
) -> jax.Array:
    """Gaussian smooth + linspace bilinear resample as two matmuls.

    Both transforms are linear per axis, so the whole pyramid
    downsampling step (reference python/lucas_kanade_pyramidal.py:44-59)
    collapses into one precomputed (out, in) matrix per axis:
    ``D = R @ G`` where G is the symmetric-boundary Gaussian operator
    and R the two-tap bilinear resampler. One pass, no intermediate
    full-resolution smoothed image in device memory, and the reduction
    runs as a matmul instead of 17-tap shifts. Composed in f64 and
    applied at HIGHEST precision (true f32, not TF32): matches the
    sequential ``gaussian_filter`` +
    ``resize_bilinear`` path to f32 rounding (~1e-6 relative), which is
    well inside the verifier's regression gate; the parity-exact
    sequential path remains available for golden comparisons.
    """
    h, w = img.shape
    out = _banded_left(_downsample_matrix_np(h, out_h, sigma), img)
    return _banded_right(out, _downsample_matrix_np(w, out_w, sigma))


# Output-block size for the banded resample/downsample matmuls. The
# composed operators are BANDED around the (scaled) diagonal — Gaussian
# taps truncate to exact zeros at radius 4*sigma and the bilinear
# resampler has two taps — so a dense (out, in) matmul burns
# in_extent/band_width x more matmul FLOPs than the nonzeros need (~8x
# at 4K for the sigma=2 downsample, ~500x for flow upsampling).
# Splitting the OUTPUT into row blocks and slicing each block's exact
# nonzero column range keeps the matmul but drops the zero tails. 256
# keeps every block matmul large while bounding the unrolled block
# count at 4K to <=9 per axis.
_BAND_BLOCK = 256


def _banded_blocks(d_np: "np.ndarray", block: int):
    """Static (row0, row1, col0, col1) block decomposition of a banded
    operator, from its exact f64 zero pattern."""
    m, n = d_np.shape
    out = []
    for b0 in range(0, m, block):
        b1 = min(b0 + block, m)
        nz = np.nonzero(np.abs(d_np[b0:b1]).sum(axis=0) > 0.0)[0]
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        out.append((b0, b1, lo, hi))
    return out


def _banded_left(d_np: "np.ndarray", img: jax.Array) -> jax.Array:
    """``D @ img`` exploiting D's band structure (see _BAND_BLOCK).

    Outputs <= _BAND_BLOCK rows take the dense branch (bit-identical to
    the previous implementation — this keeps every 320x240 parity and
    committed-baseline path exact). Larger outputs split into blocks
    whose dropped columns are exact zeros; XLA's different K-extent
    codegen (FMA contraction, reduction chunking) rounds ~1 ulp
    differently from dense — measured 3e-5 on 0..255 data at 1080p,
    inside every large-frame gate's envelope (the fast-path baselines'
    own 10% gates; same class as downsample_fused's f32 note).
    """
    m, n = d_np.shape
    if m <= _BAND_BLOCK:
        return jax.lax.dot(
            jnp.asarray(d_np, img.dtype), img,
            precision=jax.lax.Precision.HIGHEST,
        )
    outs = [
        jax.lax.dot(
            jnp.asarray(d_np[b0:b1, lo:hi], img.dtype), img[lo:hi],
            precision=jax.lax.Precision.HIGHEST,
        )
        for b0, b1, lo, hi in _banded_blocks(d_np, _BAND_BLOCK)
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)


def _banded_right(img: jax.Array, d_np: "np.ndarray") -> jax.Array:
    """``img @ D.T`` exploiting D's band structure (column blocks)."""
    m, n = d_np.shape
    if m <= _BAND_BLOCK:
        return jax.lax.dot(
            img, jnp.asarray(d_np.T, img.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
    outs = [
        jax.lax.dot(
            img[:, lo:hi], jnp.asarray(d_np[b0:b1, lo:hi].T, img.dtype),
            precision=jax.lax.Precision.HIGHEST,
        )
        for b0, b1, lo, hi in _banded_blocks(d_np, _BAND_BLOCK)
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)


@functools.lru_cache(maxsize=None)
def _downsample_matrix_np(
    n_src: int, n_dst: int, sigma: float, truncate: float = 4.0
) -> np.ndarray:
    """(n_dst, n_src) composed resample-after-blur operator, f64."""
    taps = gaussian_kernel1d(sigma, truncate)
    r = len(taps) // 2
    g = np.zeros((n_src, n_src), np.float64)
    rows = np.arange(n_src)
    for k, t in enumerate(taps):
        p = rows - r + k
        # numpy/scipy 'symmetric'/'reflect' boundary: edge included.
        p = np.where(p < 0, -1 - p, p)
        p = np.where(p >= n_src, 2 * n_src - 1 - p, p)
        np.add.at(g, (rows, p), t)
    return _resample_matrix_np(n_src, n_dst) @ g


@functools.lru_cache(maxsize=None)
def _resample_matrix_np(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) bilinear interpolation matrix for the linspace
    grid; two nonzero weights per row, computed in f64."""
    coords = linspace_grid(n_src, n_dst)
    c0 = np.clip(np.floor(coords).astype(np.int64), 0, n_src - 1)
    c1 = np.clip(c0 + 1, 0, n_src - 1)
    frac = coords - np.floor(coords)
    m = np.zeros((n_dst, n_src), np.float64)
    rows = np.arange(n_dst)
    np.add.at(m, (rows, c0), 1.0 - frac)
    np.add.at(m, (rows, c1), frac)
    return m


def _resample_matrix(n_src: int, n_dst: int, dtype) -> jax.Array:
    return jnp.asarray(_resample_matrix_np(n_src, n_dst), dtype)


def uniform_window_sum_valid(img: jax.Array, window: int) -> jax.Array:
    """Sum over every fully-interior ``window x window`` patch ('valid').

    Output shape ``(H - window + 1, W - window + 1)``. Separable: rows then
    columns. Used for the unweighted structure-tensor accumulation
    (reference: python/lucas_kanade_core.py:114-119 — uniform sums, no
    Gaussian weighting; the reference README mentions Gaussian weights but
    the authoritative code does not apply them).
    """
    ones = np.ones((window,), np.float32)
    out = _corr1d_valid(img, ones, axis=0)
    return _corr1d_valid(out, ones, axis=1)


def gaussian_window_kernel(window: int, sigma: float) -> np.ndarray:
    """Separable Gaussian window weights for optional weighted accumulation.

    The reference documents Gaussian window weighting (README.md:126-129,
    verification_config.yaml:70-72) without implementing it; we expose it
    as an opt-in flag on the LK solvers.
    """
    r = window // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    k2 = np.outer(phi, phi)
    k2 /= k2.sum()
    return k2.astype(np.float32)


def weighted_window_sum_valid(img: jax.Array, weights: np.ndarray) -> jax.Array:
    """'valid' weighted window sum with a static 2-D weight kernel."""
    return _corr2d_valid(img, weights)
