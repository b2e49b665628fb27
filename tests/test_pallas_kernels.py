"""Tests of the fused Pallas LK refine kernel and the fast path's clamped
XLA warp.

The kernel runs in the Pallas interpreter on the CPU (the analog of the
reference testing RTL without a board, SURVEY.md §4). On a GPU it
compiles through Triton; ``chip_smoke.py`` phase 1 compares that build
with ``jnp_ref`` at the 1080p and 4K level widths, and the ``gpu``-marked
test below does the same when pytest runs on a card.
"""

import numpy as np
import jax
import pytest
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from tpuflow.kernels import jnp_ref, pallas_lk


def _texture(rng, shape):
    return gaussian_filter(
        rng.uniform(0, 255, shape).astype(np.float32), 2.0
    ).astype(np.float32)


def _jnp_lk(prev, curr, window=5):
    ix, iy, it = jnp_ref.compute_gradients(prev, curr)
    return jnp_ref.lucas_kanade_from_gradients(ix, iy, it, window_size=window)


@pytest.fixture(autouse=True)
def _interpreted(request):
    """The kernel runs interpreted in every test here but the ``gpu``
    ones, which compile it for the card."""
    if request.node.get_closest_marker("gpu"):
        yield
    else:
        with pallas_lk.interpret_mode():
            yield


def _refine(prev, warped, u, v, converged=False, window=5, max_disp=8.0,
            max_disp_v=8.0):
    """The kernel on unpadded (H, W) planes; returns the cropped flow and
    the |du|, |dv| sums."""
    h, w = prev.shape
    u2, v2, sdu, sdv = pallas_lk.refine(
        pallas_lk.pad_frame(prev, window), pallas_lk.pad_frame(warped, window),
        pallas_lk.pad_flow(u), pallas_lk.pad_flow(v), jnp.asarray(converged),
        height=h, width=w, window_size=window, max_disp=max_disp,
        max_disp_v=max_disp_v,
    )
    return u2[:h, :w], v2[:h, :w], sdu, sdv


def _residual(prev, curr, window=5):
    """The kernel with zero carried flow: the single-scale LK flow."""
    z = jnp.zeros(prev.shape, jnp.float32)
    u, v, _, _ = _refine(prev, curr, z, z, window=window)
    return u, v


# ---------------------------------------------------------------------------
# The kernel against jnp_ref: shapes, blocks, windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64), (240, 320), (56, 200)])
def test_fused_lk_matches_jnp(shape, rng):
    prev = jnp.asarray(_texture(rng, shape))
    curr = jnp.asarray(_texture(rng, shape))
    ru, rv = _jnp_lk(prev, curr)
    mu, mv = _residual(prev, curr)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(ru), atol=1e-3)
    np.testing.assert_allclose(np.asarray(mv), np.asarray(rv), atol=1e-3)


def test_fused_lk_multi_tile(rng):
    # Several output blocks in both directions: each program's apron
    # loads overlap its neighbours' blocks.
    prev = jnp.asarray(_texture(rng, (96, 300)))
    curr = jnp.asarray(_texture(rng, (96, 300)))
    rows, cols = pallas_lk._geometry(96, 300)
    assert 96 // rows > 1 and 300 // cols > 1
    ru, rv = _jnp_lk(prev, curr)
    mu, mv = _residual(prev, curr)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(ru), atol=1e-3)
    np.testing.assert_allclose(np.asarray(mv), np.asarray(rv), atol=1e-3)


def test_fused_lk_ragged_height(rng):
    # Height and width not multiples of the block: the overhang is
    # computed on padding, stays zero, and is cropped.
    h, w = 52, 70
    prev = jnp.asarray(_texture(rng, (h, w)))
    curr = jnp.asarray(_texture(rng, (h, w)))
    hq, wq = pallas_lk.flow_shape(h, w)
    assert hq > h and wq > w
    z = pallas_lk.pad_flow(jnp.zeros((h, w), jnp.float32))
    u2, v2, _, _ = pallas_lk.refine(
        pallas_lk.pad_frame(prev, 5), pallas_lk.pad_frame(curr, 5), z, z,
        jnp.asarray(False), height=h, width=w,
    )
    assert u2.shape == (hq, wq)
    assert np.all(np.asarray(u2)[h:] == 0) and np.all(np.asarray(u2)[:, w:] == 0)
    ru, _ = _jnp_lk(prev, curr)
    np.testing.assert_allclose(np.asarray(u2)[:h, :w], np.asarray(ru), atol=1e-3)


def test_window_7_matches_jnp(rng):
    prev = jnp.asarray(_texture(rng, (48, 64)))
    curr = jnp.asarray(_texture(rng, (48, 64)))
    ru, rv = _jnp_lk(prev, curr, window=7)
    mu, mv = _residual(prev, curr, window=7)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(ru), atol=1e-3)
    np.testing.assert_allclose(np.asarray(mv), np.asarray(rv), atol=1e-3)


def test_window_3_matches_jnp(rng):
    prev = jnp.asarray(_texture(rng, (40, 130)))
    curr = jnp.asarray(_texture(rng, (40, 130)))
    ru, rv = _jnp_lk(prev, curr, window=3)
    mu, mv = _residual(prev, curr, window=3)
    np.testing.assert_allclose(np.asarray(mu), np.asarray(ru), atol=1e-3)
    np.testing.assert_allclose(np.asarray(mv), np.asarray(rv), atol=1e-3)


@pytest.mark.parametrize("window", [4, 1])
def test_bad_window_rejected(window):
    z = jnp.zeros((32, 64), jnp.float32)
    with pytest.raises(ValueError, match="odd"):
        pallas_lk.refine(z, z, z, z, jnp.asarray(False), height=32, width=64,
                         window_size=window)


def test_unpadded_planes_rejected():
    z = jnp.zeros((32, 64), jnp.float32)
    with pytest.raises(ValueError, match="pad_frame"):
        pallas_lk.refine(z, z, z, z, jnp.asarray(False), height=32, width=64)


@pytest.mark.parametrize(
    "shape, block",
    [
        ((2160, 3840), (32, 128)), ((1080, 1920), (16, 128)),
        ((270, 480), (8, 64)), ((20, 32), (8, 64)),
    ],
)
def test_block_geometry(shape, block):
    # Large levels take the largest block that keeps enough programs in
    # flight; small ones fall back to the smallest block.
    assert pallas_lk._geometry(*shape) == block
    hq, wq = pallas_lk.flow_shape(*shape)
    assert hq % block[0] == 0 and wq % block[1] == 0
    assert hq - shape[0] < block[0] and wq - shape[1] < block[1]


def test_backend_dispatch(rng):
    from tpuflow.flow import lucas_kanade_pyramidal

    prev = jnp.asarray(rng.uniform(0, 255, (48, 64)), jnp.float32)
    u, v = lucas_kanade_pyramidal(prev, prev, backend="pallas")
    assert u.shape == (48, 64)
    assert np.all(np.asarray(u) == 0) and np.all(np.asarray(v) == 0)


# ---------------------------------------------------------------------------
# The fast path's warp: XLA's gather on the clamped flow
# ---------------------------------------------------------------------------


def _clamped_warp(img, u, v, max_disp=8.0, max_disp_v=8.0):
    return jnp_ref.warp_image(
        img, *jnp_ref.clamp_flow(u, v, max_disp, max_disp_v)
    )


class TestClampedWarp:
    """``warp_image`` on flow saturated by ``clamp_flow``, the warp of
    both fast backends."""

    def _pair(self, rng, h=56, w=200, umax=7.5, vmax=7.5):
        img = jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
        u = jnp.asarray(rng.uniform(-umax, umax, (h, w)), jnp.float32)
        v = jnp.asarray(rng.uniform(-vmax, vmax, (h, w)), jnp.float32)
        return img, u, v

    @pytest.mark.parametrize(
        "max_disp, max_disp_v, umax, vmax",
        [(8, 8, 7.5, 7.5), (24, 24, 22.0, 22.0), (8, 3, 7.5, 2.5)],
    )
    def test_matches_jnp_warp_in_band(self, rng, max_disp, max_disp_v, umax, vmax):
        # Inside the band the clamp is inactive: exactly the parity warp.
        img, u, v = self._pair(rng, umax=umax, vmax=vmax)
        got = _clamped_warp(img, u, v, max_disp, max_disp_v)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(jnp_ref.warp_image(img, u, v))
        )

    def test_out_of_band_horizontal_saturates(self, rng):
        img = jnp.asarray(rng.uniform(1, 255, (48, 256)), jnp.float32)
        z = jnp.zeros((48, 256), jnp.float32)
        got = _clamped_warp(img, z + 20.0, z)
        # Saturated sample = the value 8 px to the right (band edge).
        want = jnp_ref.warp_image(img, z + 8.0, z)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_narrow_vertical_clamp_saturates(self, rng):
        # A narrow vertical band saturates v alone (the asymmetric clamp).
        img = jnp.asarray(rng.uniform(1, 255, (48, 128)), jnp.float32)
        z = jnp.zeros((48, 128), jnp.float32)
        got = _clamped_warp(img, z + 5.0, z + 6.0, 8.0, 3.0)
        want = jnp_ref.warp_image(img, z + 5.0, z + 3.0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_zero_flow_is_identity(self, rng):
        img = jnp.asarray(rng.uniform(0, 255, (48, 160)), jnp.float32)
        z = jnp.zeros_like(img)
        np.testing.assert_allclose(
            np.asarray(_clamped_warp(img, z, z)), np.asarray(img), atol=1e-4
        )

    def test_vmap_matches_per_frame(self, rng):
        imgs = jnp.asarray(rng.integers(0, 256, (3, 24, 128)), jnp.float32)
        us = jnp.asarray(rng.uniform(-12, 12, (3, 24, 128)), jnp.float32)
        vs = jnp.asarray(rng.uniform(-12, 12, (3, 24, 128)), jnp.float32)
        batched = jax.vmap(lambda i, u, v: _clamped_warp(i, u, v, 8.0, 3.0))(
            imgs, us, vs
        )
        for i in range(3):
            single = _clamped_warp(imgs[i], us[i], vs[i], 8.0, 3.0)
            np.testing.assert_array_equal(np.asarray(batched[i]), np.asarray(single))


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


class TestBatching:
    def _frames(self, rng, b=3, h=48, w=64):
        return [
            jnp.asarray(np.stack([_texture(rng, (h, w)) for _ in range(b)]))
            for _ in range(2)
        ]

    def test_batched_lk_matches_per_frame(self, rng):
        prev, curr = self._frames(rng)
        ub, vb = jax.vmap(_residual)(prev, curr)
        for i in range(prev.shape[0]):
            u1, v1 = _residual(prev[i], curr[i])
            np.testing.assert_allclose(np.asarray(ub[i]), np.asarray(u1), atol=1e-5)
            np.testing.assert_allclose(np.asarray(vb[i]), np.asarray(v1), atol=1e-5)

    def test_vmap_lk(self, rng):
        prev, curr = self._frames(rng)
        ub, vb = jax.jit(jax.vmap(_residual))(prev, curr)
        u1, v1 = _residual(prev[0], curr[0])
        np.testing.assert_allclose(np.asarray(ub[0]), np.asarray(u1), atol=1e-5)

    def test_batched_warp_matches_per_frame(self, rng):
        prev, _ = self._frames(rng)
        b, h, w = prev.shape
        u = jnp.asarray(rng.uniform(-10, 10, (b, h, w)), jnp.float32)
        v = jnp.asarray(rng.uniform(-10, 10, (b, h, w)), jnp.float32)
        ob = jax.vmap(_clamped_warp)(prev, u, v)
        o1 = _clamped_warp(prev[1], u[1], v[1])
        np.testing.assert_allclose(np.asarray(ob[1]), np.asarray(o1), atol=1e-5)

    def test_vmap_pyramidal(self, rng):
        # vmap through the refinement while_loop: the converged latch
        # keeps per-frame semantics while the batch runs on.
        from tpuflow.flow import lucas_kanade_pyramidal

        prev, curr = self._frames(rng, b=2)
        ub, vb = jax.vmap(
            lambda p, c: lucas_kanade_pyramidal(p, c, backend="pallas")
        )(prev, curr)
        for i in range(2):
            u1, v1 = lucas_kanade_pyramidal(prev[i], curr[i], backend="pallas")
            np.testing.assert_allclose(np.asarray(ub[i]), np.asarray(u1), atol=1e-3)
            np.testing.assert_allclose(np.asarray(vb[i]), np.asarray(v1), atol=1e-3)


# ---------------------------------------------------------------------------
# The refine step: clip, latch, accumulate, partial sums
# ---------------------------------------------------------------------------


class TestFusedRefine:
    """``pallas_lk.refine`` vs the jnp composition it fuses."""

    def _setup(self, rng, h=48, w=96):
        prev = rng.uniform(0, 255, (h, w)).astype(np.float32)
        warped = rng.uniform(0, 255, (h, w)).astype(np.float32)
        u = rng.uniform(-9.0, 9.0, (h, w)).astype(np.float32)
        v = rng.uniform(-9.0, 9.0, (h, w)).astype(np.float32)
        return (jnp.asarray(x) for x in (prev, warped, u, v))

    def test_matches_manual_composition(self, rng):
        prev, warped, u, v = self._setup(rng)
        u2, v2, sdu, sdv = _refine(prev, warped, u, v)
        du, dv = _jnp_lk(prev, warped)
        uc, vc = jnp_ref.clamp_flow(u, v, 8.0, 8.0)
        np.testing.assert_allclose(np.asarray(u2), np.asarray(uc + du), atol=1e-5)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(vc + dv), atol=1e-5)
        np.testing.assert_allclose(
            float(sdu), float(jnp.sum(jnp.abs(du))), rtol=1e-5
        )
        np.testing.assert_allclose(
            float(sdv), float(jnp.sum(jnp.abs(dv))), rtol=1e-5
        )

    def test_converged_freezes_flow(self, rng):
        prev, warped, u, v = self._setup(rng)
        u2, v2, _, _ = _refine(prev, warped, u, v, converged=True)
        uc, vc = jnp_ref.clamp_flow(u, v, 8.0, 8.0)
        np.testing.assert_array_equal(np.asarray(u2), np.asarray(uc))
        np.testing.assert_array_equal(np.asarray(v2), np.asarray(vc))

    def test_batched_and_vmap(self, rng):
        h, w = 40, 80
        prev = jnp.asarray(rng.uniform(0, 255, (2, h, w)), jnp.float32)
        warped = jnp.asarray(rng.uniform(0, 255, (2, h, w)), jnp.float32)
        u = jnp.zeros((2, h, w), jnp.float32)
        v = jnp.zeros((2, h, w), jnp.float32)
        conv = jnp.asarray([False, True])
        ub, vb, sdu, sdv = jax.vmap(_refine)(prev, warped, u, v, conv)
        u0, v0, s0, _ = _refine(prev[0], warped[0], u[0], v[0])
        assert sdu.shape == (2,)
        np.testing.assert_allclose(np.asarray(ub[0]), np.asarray(u0), atol=1e-6)
        np.testing.assert_allclose(float(sdu[0]), float(s0), rtol=1e-6)
        # Element 1 is frozen: flow passes through (zeros stay zeros).
        assert np.all(np.asarray(ub[1]) == 0)

    def test_refine_narrow_vertical_clamp(self, rng):
        # max_disp_v narrows only the vertical carried-flow clamp.
        prev, warped, u, v = self._setup(rng)
        u2, v2, _, _ = _refine(prev, warped, u, v, max_disp_v=3.0)
        du, dv = _jnp_lk(prev, warped)
        uc, vc = jnp_ref.clamp_flow(u, v, 8.0, 3.0)
        np.testing.assert_allclose(np.asarray(u2), np.asarray(uc + du), atol=1e-5)
        np.testing.assert_allclose(np.asarray(v2), np.asarray(vc + dv), atol=1e-5)


# ---------------------------------------------------------------------------
# The pyramid on the fast backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "config", ["default", "narrow_vertical", "adaptive_vertical", "production"]
)
def test_pallas_matches_xla_fast_path(config, frame_pair):
    """Both fast backends compute one semantics: the kernel's pyramid
    equals XLA's to float32 rounding, with the same iteration counts."""
    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow.pyramidal import lucas_kanade_pyramidal_from_pyramids

    cfg = PYRAMID_CONFIGS[config]
    prev, curr = (
        jnp_ref.build_gaussian_pyramid(jnp.asarray(f), cfg.levels)
        for f in frame_pair
    )
    outs = {
        b: lucas_kanade_pyramidal_from_pyramids(
            prev, curr, cfg, backend=b, return_iterations=True,
        )
        for b in ("xla", "pallas")
    }
    (ux, vx, nx), (up, vp, n_p) = outs["xla"], outs["pallas"]
    np.testing.assert_array_equal(np.asarray(nx), np.asarray(n_p))
    # The kernel adds the window sums in another order; the few pixels
    # next to the det gate amplify that rounding to a few 1e-3 px.
    for got, want in ((up, ux), (vp, vx)):
        d = np.abs(np.asarray(got) - np.asarray(want))
        assert d.mean() < 1e-4 and d.max() < 1e-2, (d.mean(), d.max())


def test_pyramidal_narrow_vertical_config(frame_pair):
    """The narrow_vertical named config stays at accuracy parity with
    the default fast path on horizontally-dominant motion — the
    production contract of the narrowed band. Pointwise the fields
    differ where LK noise exceeds +-3 px vertically (the clamp
    regularizes untextured-region garbage — measured it slightly
    *improves* MAE here), so the gate is metric-based like the
    verifier's, not bit-exact."""
    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow import lucas_kanade_pyramidal

    prev, curr = (jnp.asarray(f) for f in frame_pair)  # 2 px horizontal
    u_d, v_d = lucas_kanade_pyramidal(
        prev, curr, config=PYRAMID_CONFIGS["default"], backend="pallas",
    )
    u_n, v_n = lucas_kanade_pyramidal(
        prev, curr, config=PYRAMID_CONFIGS["narrow_vertical"],
        backend="pallas",
    )
    s = np.s_[10:-10, 10:-10]  # translation-category test region
    mae_u_d = np.abs(np.asarray(u_d)[s] - 2.0).mean()
    mae_u_n = np.abs(np.asarray(u_n)[s] - 2.0).mean()
    mae_v_d = np.abs(np.asarray(v_d)[s]).mean()
    mae_v_n = np.abs(np.asarray(v_n)[s]).mean()
    # Within the verifier's 10% regression envelope of the full band.
    assert mae_u_n <= mae_u_d * 1.10
    assert mae_v_n <= mae_v_d * 1.10


def test_pyramidal_adaptive_vertical_pallas_dispatch(frame_pair):
    """The adaptive band's lax.switch dispatch composes with the kernel
    (switch of pallas calls): on the horizontally-dominant pair it must
    reproduce the narrow band's fine levels — same composed result as in
    the XLA twin test
    (tests/test_pyramidal.py::test_adaptive_band_picks_narrow_...)."""
    import dataclasses

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.flow.pyramidal import _refine_level

    prev, curr = (jnp.asarray(f) for f in frame_pair)  # 2 px horizontal
    cfg_a = PYRAMID_CONFIGS["adaptive_vertical"]
    cfg_full = dataclasses.replace(cfg_a, adaptive_v_bands=None)
    cfg_n3 = dataclasses.replace(cfg_a, adaptive_v_bands=None, max_disp_v=3)
    u_a, v_a = lucas_kanade_pyramidal(
        prev, curr, config=cfg_a, backend="pallas"
    )
    pp = jnp_ref.build_gaussian_pyramid(prev, 3)
    pc = jnp_ref.build_gaussian_pyramid(curr, 3)
    u = jnp.zeros(pp[0].shape)
    v = jnp.zeros(pp[0].shape)
    u, v, _ = _refine_level(pp[0], pc[0], u, v, cfg_full, "pallas")
    for lvl in (1, 2):
        u, v = jnp_ref.upsample_flow(u, v, pp[lvl].shape)
        u, v, _ = _refine_level(pp[lvl], pc[lvl], u, v, cfg_n3, "pallas")
    np.testing.assert_array_equal(np.asarray(u_a), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(v_a), np.asarray(v))


def test_pyramidal_production_config_composes(frame_pair):
    """The production config (the (2, 3, 8) band ladder) runs on the
    kernel path and stays within the verifier's 10% envelope of the
    default fast path on the 8-bit bench-class pair. (The committed
    fast-path production baseline is the authoritative gate; this is
    the CI smoke that the composition itself is wired and sane.)"""
    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow import lucas_kanade_pyramidal

    cfg = PYRAMID_CONFIGS["production"]
    assert cfg.adaptive_v_bands == (2, 3, 8)
    prev, curr = (jnp.asarray(f) for f in frame_pair)  # 2 px horizontal
    u_d, v_d = lucas_kanade_pyramidal(
        prev, curr, config=PYRAMID_CONFIGS["default"], backend="pallas",
    )
    u_p, v_p = lucas_kanade_pyramidal(prev, curr, config=cfg, backend="pallas")
    s = np.s_[10:-10, 10:-10]  # translation-category test region
    mae_u_d = np.abs(np.asarray(u_d)[s] - 2.0).mean()
    mae_u_p = np.abs(np.asarray(u_p)[s] - 2.0).mean()
    mae_v_d = np.abs(np.asarray(v_d)[s]).mean()
    mae_v_p = np.abs(np.asarray(v_p)[s]).mean()
    assert mae_u_p <= mae_u_d * 1.10
    assert mae_v_p <= mae_v_d * 1.10


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1080, 1920), (2160, 3840)])
def test_compiled_kernel_matches_jnp_on_gpu(shape, rng, gpu):
    """The Triton build at the 1080p and 4K finest-level widths (also
    chip_smoke.py phase 1)."""
    prev_np = _texture(rng, shape)
    prev = jnp.asarray(prev_np)
    warped = jnp.asarray(np.roll(prev_np, 1, axis=1))
    u = jnp.asarray(rng.uniform(-10, 10, shape), jnp.float32)
    v = jnp.asarray(rng.uniform(-10, 10, shape), jnp.float32)
    with jax.default_matmul_precision("highest"):
        du, dv = _jnp_lk(prev, warped)
    uc, vc = jnp_ref.clamp_flow(u, v, 8.0, 8.0)
    u2, v2, _, _ = _refine(prev, warped, u, v)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(uc + du), atol=1e-3)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(vc + dv), atol=1e-3)
