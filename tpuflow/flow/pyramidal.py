"""Pyramidal (coarse-to-fine) Lucas-Kanade dense flow.

JAX equivalent of the reference's pyramidal path — the Python
golden model (python/lucas_kanade_pyramidal.py:141-228) and the RTL
pyramid_control_fsm sequence BUILD -> SOLVE_L0 -> UPSAMPLE -> WARP ->
SOLVE -> ACCUM per level (rtl/unopt/pyramid_control_fsm.sv:59-152). The
RTL's 12-state FSM becomes ordinary traced control flow: a static Python
loop over levels (shapes differ per level) and a ``lax.while_loop`` over
refinement iterations with the reference's early-exit test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuflow.core.config import PyramidConfig
from tpuflow.flow.backend import Backend, is_clamped
from tpuflow.flow.single_scale import lucas_kanade_single_scale
from tpuflow.kernels import jnp_ref


def _refine_level(
    img_prev: jax.Array,
    img_curr: jax.Array,
    flow_u: jax.Array,
    flow_v: jax.Array,
    cfg: PyramidConfig,
    backend: Backend,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Iterative warp -> residual-LK -> accumulate at one pyramid level.

    Matches reference python/lucas_kanade_pyramidal.py:201-223: the
    residual is always accumulated, then the loop exits early once both
    mean |du| and mean |dv| drop below the convergence threshold. The
    fast backends first saturate the carried flow at the level's band
    (PyramidConfig.max_disp / max_disp_v). Returns ``(u, v, n)`` with
    ``n`` the number of iterations run.
    """
    clamped = is_clamped(backend)
    h, w = img_prev.shape
    n_px = h * w

    def clip(u, v):
        if not clamped:
            return u, v
        return jnp_ref.clamp_flow(u, v, cfg.max_disp, cfg.max_disp_v_effective)

    def cond(state):
        _, _, i, converged = state
        return jnp.logical_and(i < cfg.iterations, jnp.logical_not(converged))

    if backend == "pallas":
        from tpuflow.kernels import pallas_lk

        # The kernel reads padded planes: pad the level's prev frame and
        # carried flow once, not per iteration.
        prev_p = pallas_lk.pad_frame(img_prev, cfg.window_size)
        flow_u = pallas_lk.pad_flow(flow_u)
        flow_v = pallas_lk.pad_flow(flow_v)

        def body(state):
            u, v, i, converged = state
            with jax.named_scope("warp"):
                u_c, v_c = clip(u[:h, :w], v[:h, :w])
                warped = pallas_lk.pad_frame(
                    jnp_ref.warp_image(img_curr, u_c, v_c), cfg.window_size
                )
            with jax.named_scope("lk_refine"):
                u, v, sdu, sdv = pallas_lk.refine(
                    prev_p, warped, u, v, converged, height=h, width=w,
                    window_size=cfg.window_size,
                    det_threshold=cfg.det_threshold,
                    max_disp=float(cfg.max_disp),
                    max_disp_v=float(cfg.max_disp_v_effective),
                )
            now_converged = jnp.logical_and(
                sdu / n_px < cfg.convergence_threshold,
                sdv / n_px < cfg.convergence_threshold,
            )
            return u, v, i + 1, jnp.logical_or(converged, now_converged)

    else:

        def body(state):
            u, v, i, converged = state
            with jax.named_scope("warp"):
                u, v = clip(u, v)
                warped = jnp_ref.warp_image(img_curr, u, v)
            with jax.named_scope("lk_refine"):
                du, dv = lucas_kanade_single_scale(
                    img_prev, warped, cfg.window_size,
                    det_threshold=cfg.det_threshold,
                )
            # Latch on convergence: under vmap the while_loop runs until
            # every batch element converges, so already-converged
            # elements must stop accumulating to keep per-frame semantics
            # (the reference's break, python/lucas_kanade_pyramidal.py:
            # 221-223).
            u = jnp.where(converged, u, u + du)
            v = jnp.where(converged, v, v + dv)
            now_converged = jnp.logical_and(
                jnp.mean(jnp.abs(du)) < cfg.convergence_threshold,
                jnp.mean(jnp.abs(dv)) < cfg.convergence_threshold,
            )
            return u, v, i + 1, jnp.logical_or(converged, now_converged)

    # Tie the carry's device-varying annotation to the image data: under
    # shard_map, all-gathered frames are marked varying while a fresh
    # zeros/False init is not, and while_loop requires a stable carry
    # type. Adding a data-derived zero/False keeps values identical while
    # inheriting the variance annotation in every context.
    tie = img_prev[0, 0] * 0.0
    init = (
        flow_u + tie,
        flow_v + tie,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False) | (tie > 1.0),
    )
    u, v, n, _ = jax.lax.while_loop(cond, body, init)
    return u[:h, :w], v[:h, :w], n


def _select_band_index(
    flow_v: jax.Array,
    bands: tuple[int, ...],
    frac_threshold: float,
    margin: int,
) -> jax.Array:
    """Index of the narrowest adequate vertical band, from the upsampled
    coarse-level flow.

    Masked-interior, fraction-based: candidate band ``b`` is rejected if
    more than ``frac_threshold`` of interior |v| exceeds ``b - 1`` (1 px
    headroom for residual growth within the level). The border margin
    excludes warp-OOB / clamp garbage — the unmasked global max always
    saturated at the clamp and defeated the earlier two-variant dispatch
    (DESIGN.md §3); measured on translate_medium, the coarse level's
    garbage stripe is (max_disp + window) px wide and upsampling doubles
    it, so the margin must be 2x that (a 16 px margin still saw 0.87%
    contaminated pixels; 24 px leaves 0.03%). Rejection counts are
    monotone in b, so the index is just the number of rejected non-final
    candidates.
    """
    h, w = flow_v.shape
    m_y = min(margin, max((h - 1) // 2, 0))
    m_x = min(margin, max((w - 1) // 2, 0))
    interior = jnp.abs(flow_v[m_y : h - m_y, m_x : w - m_x])
    n = interior.size
    idx = jnp.asarray(0, jnp.int32)
    for b in bands[:-1]:
        frac = jnp.sum((interior > (b - 1.0)).astype(jnp.float32)) / n
        idx = idx + (frac > frac_threshold).astype(jnp.int32)
    return idx


def _refine_level_adaptive(
    img_prev: jax.Array,
    img_curr: jax.Array,
    flow_u: jax.Array,
    flow_v: jax.Array,
    cfg: PyramidConfig,
    backend: Backend,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """``_refine_level`` with the vertical band picked at the level
    boundary: one compiled variant per candidate band, dispatched by
    ``lax.switch`` on the coarse solve's interior |v| statistics. Outside
    vmap only the selected branch executes, so benign streams run at the
    narrow band while vertical motion keeps the full band — the adaptive
    form of the static ``narrow_vertical`` trade.
    """
    import dataclasses

    bands = cfg.adaptive_v_bands
    assert bands is not None
    margin = 2 * (cfg.max_disp + cfg.window_size)
    idx = _select_band_index(flow_v, bands, cfg.adaptive_v_frac, margin)

    def variant(b: int):
        vcfg = dataclasses.replace(cfg, max_disp_v=b, adaptive_v_bands=None)
        return lambda u, v: _refine_level(
            img_prev, img_curr, u, v, vcfg, backend
        )

    return jax.lax.switch(idx, [variant(b) for b in bands], flow_u, flow_v)


def lucas_kanade_pyramidal(
    frame_prev: jax.Array,
    frame_curr: jax.Array,
    num_levels: int = 3,
    window_size: int = 5,
    num_iterations: int = 3,
    *,
    config: PyramidConfig | None = None,
    backend: Backend = "jnp",
    return_levels: bool = False,
):
    """Coarse-to-fine dense flow.

    Matches reference python/lucas_kanade_pyramidal.py:141-228: Gaussian
    pyramids (sigma = 1/scale smoothing + linspace bilinear resample),
    zero flow at the coarsest level, per level upsample-and-scale then
    ``num_iterations`` x (warp, residual LK, accumulate) with early exit.
    ``backend="jnp"`` (the default) keeps the golden model's semantics;
    the fast backends (``tpuflow.flow.backend``) add per-level flow
    saturation and the config's adaptive band ladder.

    ``return_levels=True`` additionally returns the per-level refined
    flow fields ``[(u_0, v_0), ...]`` (coarsest first) as pure outputs —
    the pure-function form of the reference's per-level diagnostic
    snapshots (python/lucas_kanade_pyramidal.py:226, 313-352), which
    side-effect PNG writes from inside the solve loop; here the traced
    function stays pure and ``tpuflow.eval.visualize
    .save_pyramid_levels`` renders them.
    """
    cfg = config or PyramidConfig(
        levels=num_levels, window_size=window_size, iterations=num_iterations
    )

    with jax.named_scope("pyramid"):
        pyr_prev = jnp_ref.build_gaussian_pyramid(
            frame_prev, cfg.levels, cfg.scale_factor
        )
        pyr_curr = jnp_ref.build_gaussian_pyramid(
            frame_curr, cfg.levels, cfg.scale_factor
        )
    return lucas_kanade_pyramidal_from_pyramids(
        pyr_prev, pyr_curr, cfg, backend=backend, return_levels=return_levels,
    )


def lucas_kanade_pyramidal_from_pyramids(
    pyr_prev,
    pyr_curr,
    cfg: PyramidConfig,
    *,
    backend: Backend = "jnp",
    return_levels: bool = False,
    return_iterations: bool = False,
):
    """Coarse-to-fine refinement on prebuilt Gaussian pyramids.

    Same semantics as ``lucas_kanade_pyramidal`` given
    ``jnp_ref.build_gaussian_pyramid`` outputs — split out so streaming
    callers can reuse each frame's pyramid as ``prev`` for the next pair
    (``lucas_kanade_pyramidal_step``) instead of rebuilding it, the
    serving-path analog of the RTL keeping both frame pyramids resident
    in BRAM across the solve (optical_flow_top_pyramidal.sv:189-293).

    ``return_iterations=True`` appends an int32 ``(levels,)`` array of
    the refinement iterations each level ran (coarsest first): the
    data-dependent early exit can flip on last-bit differences, so
    comparisons between devices report it beside the flow.
    """
    h0, w0 = pyr_prev[0].shape
    flow_u = jnp.zeros((h0, w0), pyr_prev[0].dtype)
    flow_v = jnp.zeros((h0, w0), pyr_prev[0].dtype)

    # Adaptive vertical band applies only where the band exists at all
    # (the fast backends; the jnp parity path never clamps) and
    # only at levels with a coarse predecessor to derive it from — the
    # coarsest level always refines at the full band (it is tiny and its
    # warp is cheap).
    adaptive = cfg.adaptive_v_bands is not None and is_clamped(backend)

    levels = []
    iterations = []
    for level in range(cfg.levels):
        img_prev = pyr_prev[level]
        img_curr = pyr_curr[level]
        with jax.named_scope(f"level{level}"):
            if level > 0:
                with jax.named_scope("upsample"):
                    flow_u, flow_v = jnp_ref.upsample_flow(
                        flow_u, flow_v, img_prev.shape
                    )
            refine = (
                _refine_level_adaptive if adaptive and level > 0
                else _refine_level
            )
            flow_u, flow_v, n = refine(
                img_prev, img_curr, flow_u, flow_v, cfg, backend
            )
        levels.append((flow_u, flow_v))
        iterations.append(n)

    out = (flow_u, flow_v)
    if return_levels:
        out += (levels,)
    if return_iterations:
        out += (jnp.stack(iterations),)
    return out


def lucas_kanade_pyramidal_step(
    pyr_prev,
    frame_curr: jax.Array,
    cfg: PyramidConfig,
    *,
    backend: Backend = "jnp",
    return_iterations: bool = False,
):
    """One streaming flow step: ``(pyr_prev, frame) -> (u, v, pyr_curr)``.

    Builds only the NEW frame's pyramid and returns it as the next
    step's carry, halving pyramid-build work on frame streams while
    staying bit-identical to per-pair ``lucas_kanade_pyramidal`` (the
    pyramid of a frame does not depend on which pair it appears in).
    Seed the carry with ``jnp_ref.build_gaussian_pyramid(first_frame,
    cfg.levels, cfg.scale_factor)``. ``return_iterations=True`` adds
    the per-level iteration counts before the carry (see
    ``lucas_kanade_pyramidal_from_pyramids``).
    """
    with jax.named_scope("pyramid"):
        pyr_curr = jnp_ref.build_gaussian_pyramid(
            frame_curr, cfg.levels, cfg.scale_factor
        )
    out = lucas_kanade_pyramidal_from_pyramids(
        pyr_prev, pyr_curr, cfg, backend=backend,
        return_iterations=return_iterations,
    )
    return (*out, pyr_curr)
