"""Pyramidal LK component and integration tests."""

import numpy as np
import pytest
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter as sp_gauss
from scipy.ndimage import map_coordinates

from tpuflow.core.config import PyramidConfig
from tpuflow.flow import lucas_kanade_pyramidal
from tpuflow.kernels import jnp_ref


def ref_downsample(image, scale=0.5):
    """Reference downsampling semantics (python/lucas_kanade_pyramidal.py:44-59)."""
    smoothed = sp_gauss(image, sigma=1.0 / scale)
    h, w = smoothed.shape
    nh, nw = int(h * scale), int(w * scale)
    yy, xx = np.meshgrid(
        np.linspace(0, h - 1, nh), np.linspace(0, w - 1, nw), indexing="ij"
    )
    return map_coordinates(smoothed, [yy, xx], order=1, mode="constant")


def test_pyramid_shapes_and_order(frame_pair):
    prev, _ = frame_pair
    pyr = jnp_ref.build_gaussian_pyramid(jnp.asarray(prev), 3)
    # Level 0 = coarsest (reference: lucas_kanade_pyramidal.py:61).
    assert pyr[0].shape == (60, 80)
    assert pyr[1].shape == (120, 160)
    assert pyr[2].shape == (240, 320)
    np.testing.assert_array_equal(np.asarray(pyr[2]), prev)


def test_downsample_matches_reference_semantics(frame_pair):
    prev, _ = frame_pair
    ref = ref_downsample(prev)
    got = np.asarray(jnp_ref.downsample_image(jnp.asarray(prev)))
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_warp_matches_map_coordinates(frame_pair, rng):
    prev, _ = frame_pair
    h, w = prev.shape
    u = rng.uniform(-10, 10, (h, w)).astype(np.float32)
    v = rng.uniform(-10, 10, (h, w)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = map_coordinates(prev, [yy + v, xx + u], order=1, mode="constant", cval=0.0)
    got = np.asarray(jnp_ref.warp_image(jnp.asarray(prev), jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, atol=1e-2)


def test_upsample_flow_scales_magnitude(rng):
    u = rng.uniform(-2, 2, (30, 40)).astype(np.float32)
    v = rng.uniform(-2, 2, (30, 40)).astype(np.float32)
    uu, vv = jnp_ref.upsample_flow(jnp.asarray(u), jnp.asarray(v), (60, 80))
    assert uu.shape == (60, 80)
    # Magnitudes double with resolution (reference:
    # lucas_kanade_pyramidal.py:134-136); corners map exactly.
    np.testing.assert_allclose(np.asarray(uu)[0, 0], u[0, 0] * 2.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(vv)[-1, -1], v[-1, -1] * 2.0, rtol=1e-5)


def test_upsample_matches_reference_semantics(rng):
    u = rng.uniform(-2, 2, (60, 80)).astype(np.float32)
    yy, xx = np.meshgrid(
        np.linspace(0, 59, 120), np.linspace(0, 79, 160), indexing="ij"
    )
    ref = map_coordinates(u, [yy, xx], order=1, mode="constant") * 2.0
    got, _ = jnp_ref.upsample_flow(jnp.asarray(u), jnp.asarray(u), (120, 160))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4)


def test_pyramidal_beats_single_scale_on_large_motion(frame_pair):
    # 2 px motion: pyramidal should produce a sane flow field; the real
    # large-motion check is the 13-pattern regression test.
    prev, curr = frame_pair
    u, v = lucas_kanade_pyramidal(jnp.asarray(prev), jnp.asarray(curr))
    assert u.shape == prev.shape
    interior = np.asarray(u)[20:-20, 20:-20]
    assert 0.2 < interior.mean() < 4.0


def test_no_motion_is_exactly_zero(frame_pair):
    prev, _ = frame_pair
    u, v = lucas_kanade_pyramidal(jnp.asarray(prev), jnp.asarray(prev))
    assert np.all(np.asarray(u) == 0)
    assert np.all(np.asarray(v) == 0)


def test_named_configs(frame_pair):
    prev, curr = frame_pair
    cfg = PyramidConfig(levels=2, window_size=5, iterations=1)
    u, v = lucas_kanade_pyramidal(jnp.asarray(prev), jnp.asarray(curr), config=cfg)
    assert u.shape == prev.shape


def test_return_levels(frame_pair):
    """return_levels yields one refined (u, v) per level, coarsest
    first, with the last level identical to the plain output (pure-
    output analog of the reference's per-level snapshots,
    python/lucas_kanade_pyramidal.py:226)."""
    prev, curr = (jnp.asarray(f) for f in frame_pair)
    u, v = lucas_kanade_pyramidal(prev, curr)
    u2, v2, levels = lucas_kanade_pyramidal(prev, curr, return_levels=True)
    assert len(levels) == 3
    h, w = prev.shape
    assert levels[0][0].shape == (h // 4, w // 4)
    assert levels[1][0].shape == (h // 2, w // 2)
    assert levels[2][0].shape == (h, w)
    np.testing.assert_array_equal(np.asarray(levels[2][0]), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(u2), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(v2), np.asarray(v))


def test_streaming_step_matches_pairwise(frame_pair):
    """lucas_kanade_pyramidal_step (pyramid carried between pairs) is
    bit-identical to independent per-pair calls over a 3-frame stream."""
    from tpuflow.flow import lucas_kanade_pyramidal_step

    f0, f1 = frame_pair
    f2 = np.roll(f1, 1, axis=1)
    frames = [jnp.asarray(f) for f in (f0, f1, f2)]
    cfg = PyramidConfig()

    carry = jnp_ref.build_gaussian_pyramid(frames[0], cfg.levels, cfg.scale_factor)
    streamed = []
    for f in frames[1:]:
        u, v, carry = lucas_kanade_pyramidal_step(carry, f, cfg)
        streamed.append((np.asarray(u), np.asarray(v)))

    for (us, vs), (p, c) in zip(streamed, zip(frames, frames[1:])):
        up, vp = lucas_kanade_pyramidal(p, c)
        np.testing.assert_array_equal(us, np.asarray(up))
        np.testing.assert_array_equal(vs, np.asarray(vp))


# ---------------------------------------------------------------------------
# Adaptive vertical band (PyramidConfig.adaptive_v_bands): the coarse
# solve picks each finer level's band at the level boundary (lax.switch
# over precompiled variants — in-kernel gating measured harmful,
# DESIGN.md §3).
# ---------------------------------------------------------------------------


def _pattern_pair(name):
    from tpuflow.eval import patterns

    mp = patterns.TEST_PATTERNS[name]
    f0 = patterns.load_base_texture(320, 240)
    f1 = patterns.apply_motion(f0, mp)
    return jnp.asarray(f0, jnp.float32), jnp.asarray(f1, jnp.float32)


def test_select_band_index_masked_interior():
    """Border garbage must not widen the band; real interior motion must."""
    from tpuflow.flow.pyramidal import _select_band_index

    v = jnp.zeros((240, 320))
    assert int(_select_band_index(v, (3, 8), 0.005, 26)) == 0
    # Saturated garbage confined to the border stripe: still narrow.
    v_border = v.at[:, :20].set(8.0).at[:10, :].set(-8.0)
    assert int(_select_band_index(v_border, (3, 8), 0.005, 26)) == 0
    # A real moving region in the interior: widen.
    v_blob = v.at[100:160, 120:220].set(6.0)
    assert int(_select_band_index(v_blob, (3, 8), 0.005, 26)) == 1
    # Sparse interior outliers below the fraction threshold: narrow.
    v_dust = v.at[100, 100:130].set(8.0)
    assert int(_select_band_index(v_dust, (3, 8), 0.005, 26)) == 0
    # Three candidates: counts are monotone, index picks the middle.
    v_mid = v.at[100:160, 120:220].set(3.5)
    assert int(_select_band_index(v_mid, (3, 5, 8), 0.005, 26)) == 1


def test_adaptive_band_config_validation():
    import pytest as _pytest

    with _pytest.raises(ValueError):
        PyramidConfig(adaptive_v_bands=(8, 3))
    with _pytest.raises(ValueError):
        PyramidConfig(adaptive_v_bands=(3,))
    with _pytest.raises(ValueError):
        PyramidConfig(adaptive_v_bands=(3, 9), max_disp=8)


def test_adaptive_band_picks_full_on_vertical_motion():
    """translate_vertical (GT v=10): every level boundary must select the
    full band, making the adaptive output bit-identical to the static
    full-band fast path — the accuracy contract the static narrow band
    breaks (EPE 2.92 -> 8.00, docs/verification_results_fast.md)."""
    import dataclasses

    from tpuflow.core.config import PYRAMID_CONFIGS

    f0, f1 = _pattern_pair("translate_vertical")
    cfg_a = PYRAMID_CONFIGS["adaptive_vertical"]
    cfg_full = dataclasses.replace(cfg_a, adaptive_v_bands=None)
    ua, va = lucas_kanade_pyramidal(
        f0, f1, config=cfg_a, backend="xla"
    )
    uf, vf = lucas_kanade_pyramidal(
        f0, f1, config=cfg_full, backend="xla"
    )
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(uf))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vf))


def test_adaptive_band_picks_narrow_on_horizontal_motion():
    """translate_medium (GT v=0): both finer levels must select the
    narrow band — bit-identical to a manually composed L0-full /
    L1+-narrow run (the coarsest level always runs the full band)."""
    import dataclasses

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow.pyramidal import _refine_level

    f0, f1 = _pattern_pair("translate_medium")
    cfg_a = PYRAMID_CONFIGS["adaptive_vertical"]
    cfg_full = dataclasses.replace(cfg_a, adaptive_v_bands=None)
    cfg_n3 = dataclasses.replace(cfg_a, adaptive_v_bands=None, max_disp_v=3)

    ua, va = lucas_kanade_pyramidal(
        f0, f1, config=cfg_a, backend="xla"
    )
    pp = jnp_ref.build_gaussian_pyramid(f0, 3)
    pc = jnp_ref.build_gaussian_pyramid(f1, 3)
    u = jnp.zeros(pp[0].shape)
    v = jnp.zeros(pp[0].shape)
    u, v, _ = _refine_level(pp[0], pc[0], u, v, cfg_full, "xla")
    for lvl in (1, 2):
        u, v = jnp_ref.upsample_flow(u, v, pp[lvl].shape)
        u, v, _ = _refine_level(pp[lvl], pc[lvl], u, v, cfg_n3, "xla")
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(v))


def test_adaptive_band_ignored_in_parity_mode():
    """The jnp parity path has no clamps, so adaptive_v_bands must be a
    no-op there (golden-model semantics preserved)."""
    from tpuflow.core.config import PYRAMID_CONFIGS

    f0, f1 = _pattern_pair("translate_medium")
    ua, va = lucas_kanade_pyramidal(
        f0, f1, config=PYRAMID_CONFIGS["adaptive_vertical"], backend="jnp"
    )
    ud, vd = lucas_kanade_pyramidal(
        f0, f1, config=PYRAMID_CONFIGS["default"], backend="jnp"
    )
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(ud))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vd))


@pytest.mark.parametrize(
    "pattern, band", [("translate_medium", 2), ("translate_vertical", 8)]
)
def test_production_ladder_dispatch(pattern, band):
    """The serving config's (2, 3, 8) ladder on the fast path: benign
    horizontal motion runs the finer levels at +-2, real vertical motion
    escalates them to the full band. Either way the result is
    bit-identical to the manually composed static-band run (the
    coarsest level always refines at the full band)."""
    import dataclasses

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow.pyramidal import _refine_level

    f0, f1 = _pattern_pair(pattern)
    cfg = PYRAMID_CONFIGS["production"]
    cfg_full = dataclasses.replace(cfg, adaptive_v_bands=None)
    cfg_band = dataclasses.replace(cfg, adaptive_v_bands=None, max_disp_v=band)

    ua, va = lucas_kanade_pyramidal(f0, f1, config=cfg, backend="xla")
    pp = jnp_ref.build_gaussian_pyramid(f0, 3)
    pc = jnp_ref.build_gaussian_pyramid(f1, 3)
    u = jnp.zeros(pp[0].shape)
    v = jnp.zeros(pp[0].shape)
    u, v, _ = _refine_level(pp[0], pc[0], u, v, cfg_full, "xla")
    for lvl in (1, 2):
        u, v = jnp_ref.upsample_flow(u, v, pp[lvl].shape)
        u, v, _ = _refine_level(pp[lvl], pc[lvl], u, v, cfg_band, "xla")
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(v))


@pytest.mark.parametrize("backend", ["jnp", "xla"])
def test_step_reports_iterations(backend):
    """``return_iterations`` reports each level's refinement count
    (coarsest first) without changing the flow."""
    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow.pyramidal import lucas_kanade_pyramidal_step

    f0, f1 = _pattern_pair("translate_medium")
    cfg = PYRAMID_CONFIGS["production"]
    pyr = jnp_ref.build_gaussian_pyramid(f0, cfg.levels)
    u, v, n, _ = lucas_kanade_pyramidal_step(
        pyr, f1, cfg, backend=backend, return_iterations=True
    )
    u2, v2, _ = lucas_kanade_pyramidal_step(pyr, f1, cfg, backend=backend)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))
    np.testing.assert_array_equal(np.asarray(v), np.asarray(v2))
    n = np.asarray(n)
    assert n.shape == (cfg.levels,) and n.dtype == np.int32
    assert np.all((n >= 1) & (n <= cfg.iterations))
