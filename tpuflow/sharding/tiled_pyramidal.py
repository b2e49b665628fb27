"""Multi-chip tiled pyramidal Lucas-Kanade flow.

Level-dependent sharding strategy (SURVEY.md §7 step 6 / §5
"halo correctness across pyramid levels"), round 5: the pyramid BUILD
is distributed.

- **Every level whose tile is big enough is sharded end-to-end.** The
  pyramid downsample and the flow upsampler are banded per-axis
  operators, so each device computes its tile of every level from its
  own rows plus a ~10-px halo exchanged between devices
  (``tpuflow.sharding.dist_pyramid``) — no full-frame ``all_gather``.
  At 1080p on a (2, 2) or (2, 4) mesh and at 4K up to (4, 4), every
  level shards: per-frame communication is halo strips only, the term
  that kept the r4 scaling model's tiled axis at 0.54 efficiency @ 4
  chips (all_gather of both frames) is gone. Reference analog: each RTL
  pyramid_builder consumes its own stream without a global gather
  (/root/reference/rtl/unopt/pyramid_builder.sv:22-404).
- **Levels with too-small tiles stay replicated.** A level is sharded
  only if its dims divide the mesh and its tile exceeds twice the warp
  halo (coarse 80x60-class levels fail this); the coarsest sharded
  level is all_gathered ONCE (that level's pixels, not the full frame)
  and the remaining coarse levels build + solve replicated —
  deterministic, so every device holds identical coarse flow. When only
  the finest level shards (tiny test frames), this degenerates to the
  r4 design: the gathered "level" is the raw frame.
- **Sharded refinement** per level: the current-frame tile is
  halo-extended by ``max_disp + 1`` rows/cols (RTL-clamp-bounded warp
  reads, flow_solver.sv:134-144 analog) for the warp, then by the
  3-pixel Sobel+window apron for the residual LK solve; convergence
  tests psum the global |residual| means.

Semantics: matches the single-device fast path
(``lucas_kanade_pyramidal(..., backend="xla")``) — exactly when only
the finest level shards, and to f32 rounding of the banded per-device
operator contractions (~1 ulp on level images; see
``dist_pyramid.sharded_downsample``) when coarse levels shard too.
Verified in tests/test_sharding.py. The adaptive vertical-band ladder
(``PyramidConfig.adaptive_v_bands``) is NOT applied on the tiled path —
it runs the static ``max_disp_v_effective`` band at every level (the
ladder's global interior-|v| statistics would need an extra psum per
level boundary; a latency lever, not a semantics gap).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuflow.core import ops
from tpuflow.core.config import PyramidConfig
from tpuflow.kernels import jnp_ref
from tpuflow.sharding import dist_pyramid
from tpuflow.sharding import halo as halo_mod
from tpuflow.sharding.tiled_flow import HALO, _local_lk


def _level_shapes(
    gh: int, gw: int, levels: int, scale_factor: float
) -> list[tuple[int, int]]:
    """Global (h, w) per level, coarse -> fine — the same dims
    ``jnp_ref.build_gaussian_pyramid`` produces."""
    dims = [(gh, gw)]
    h, w = gh, gw
    for _ in range(levels - 1):
        h, w = int(h * scale_factor), int(w * scale_factor)
        dims.append((h, w))
    dims.reverse()
    return dims


def _shard_plan(
    dims: list[tuple[int, int]], ty: int, tx: int, warp_halo: int
) -> list[bool]:
    """Which levels run sharded (static): a level shards iff its dims
    divide the mesh, its tile exceeds twice the warp halo, and every
    FINER level shards too (the build walks fine -> coarse; once a
    level gathers, coarser levels stay replicated)."""
    sharded = [False] * len(dims)
    ok = True
    for lvl in range(len(dims) - 1, -1, -1):
        h, w = dims[lvl]
        good = (
            h % ty == 0
            and w % tx == 0
            and h // ty > 2 * warp_halo
            and w // tx > 2 * warp_halo
        )
        ok = ok and good
        sharded[lvl] = ok
    return sharded


def _warp_tile(img_ext, u, v, halo, gy0, gx0, gh, gw):
    """Backward warp of a halo-extended tile with local flow.

    img_ext: (h + 2*halo, w + 2*halo); |u|,|v| <= halo - 1 guaranteed by
    the caller's clamp. Samples at the global coordinates, so every
    fractional part, and every sample, is the single-device warp's
    (``jnp_ref.warp_image``): tile-local coordinates round the fractions
    differently, and on noisy texture the refinement turns that into
    flow differences of 1e-3 px. Out of range of the global image -> 0.
    """
    h, w = u.shape
    yy = (lax.broadcasted_iota(jnp.int32, (h, w), 0) + gy0).astype(jnp.float32)
    xx = (lax.broadcasted_iota(jnp.int32, (h, w), 1) + gx0).astype(jnp.float32)
    return ops.map_coordinates_bilinear(
        img_ext, yy + v, xx + u, cval=0.0,
        origin=(gy0 - halo, gx0 - halo), bounds=(gh, gw),
    )


def _local_lk_pallas(prev_t, warped, gy0, gx0, gh, gw, ty, tx,
                     window, det_threshold):
    """Per-shard residual LK through the fused Pallas refine kernel
    (twin of :func:`tpuflow.sharding.tiled_flow._local_lk`).

    The 3-px Sobel+window apron travels by halo exchange of the raw
    prev/warped tiles (symm boundary == the kernel's own symm pad for
    the one ring that matters); the kernel then treats the extended tile
    as a standalone image with zero carried flow, so its output is the
    residual. Its border handling of the OUTER ring only affects outputs
    inside the cropped-away halo; the global half-window border zeroing
    is reapplied by mask."""
    from tpuflow.kernels import pallas_lk

    half = window // 2
    ext = half + 1  # Sobel reach beyond the window ring
    h, w = prev_t.shape
    prev_ext = halo_mod.exchange_halo_2d(
        prev_t, ext, ty=ty, tx=tx, boundary="symm"
    )
    warped_ext = halo_mod.exchange_halo_2d(
        warped, ext, ty=ty, tx=tx, boundary="symm"
    )
    he, we = prev_ext.shape
    zero = pallas_lk.pad_flow(jnp.zeros((he, we), jnp.float32))
    du_e, dv_e, _, _ = pallas_lk.refine(
        pallas_lk.pad_frame(prev_ext, window),
        pallas_lk.pad_frame(warped_ext, window),
        zero, zero, jnp.asarray(False), height=he, width=we,
        window_size=window, det_threshold=det_threshold,
    )
    du = lax.dynamic_slice(du_e, (ext, ext), (h, w))
    dv = lax.dynamic_slice(dv_e, (ext, ext), (h, w))
    rows = lax.broadcasted_iota(jnp.int32, (h, w), 0) + gy0
    cols = lax.broadcasted_iota(jnp.int32, (h, w), 1) + gx0
    interior = (
        (rows >= half) & (rows < gh - half)
        & (cols >= half) & (cols < gw - half)
    )
    return jnp.where(interior, du, 0.0), jnp.where(interior, dv, 0.0)


def tiled_lucas_kanade_pyramidal(
    frame_prev: jax.Array,
    frame_curr: jax.Array,
    mesh: Mesh,
    config: PyramidConfig | None = None,
    backend: str = "xla",
) -> tuple[jax.Array, jax.Array]:
    """Pyramidal flow over ("batch", "ty", "tx")-sharded (B, H, W) frames.

    Always runs fast-path semantics: matches
    ``lucas_kanade_pyramidal(..., backend="xla")`` (see the module
    docstring for the exactness statement). ``backend="pallas"`` runs
    the per-shard LK solves, and the replicated coarse levels, through
    the fused Pallas refine kernel; any other backend leaves them to
    XLA.
    """
    use_kernel = backend == "pallas"
    level_backend = "pallas" if use_kernel else "xla"
    cfg = config or PyramidConfig()
    ty = mesh.shape["ty"]
    tx = mesh.shape["tx"]
    _, gh, gw = frame_prev.shape
    assert gh % ty == 0 and gw % tx == 0
    warp_halo = cfg.max_disp + 1
    sigma = 1.0 / cfg.scale_factor
    dims = _level_shapes(gh, gw, cfg.levels, cfg.scale_factor)
    sharded = _shard_plan(dims, ty, tx, warp_halo)
    assert sharded[-1], (
        f"finest-level tiles ({gh // ty}x{gw // tx}) must exceed twice "
        f"the warp halo ({2 * warp_halo})"
    )
    n_levels = cfg.levels
    # Coarsest sharded level (always exists: the finest shards).
    first_sharded = sharded.index(True)

    spec = P("batch", "ty", "tx")

    def refine_sharded(prev_t, curr_t, u, v, lvl):
        """Sharded refinement iterations on local tiles of level lvl."""
        lh, lw = dims[lvl]
        th, tw = lh // ty, lw // tx
        gy0 = lax.axis_index("ty") * th
        gx0 = lax.axis_index("tx") * tw

        def cond(state):
            _, _, i, converged = state
            return jnp.logical_and(i < cfg.iterations, ~converged)

        def body(state):
            u, v, i, converged = state
            # The single-device fast path's clamp, so tiled == single.
            u, v = jnp_ref.clamp_flow(
                u, v, cfg.max_disp, cfg.max_disp_v_effective
            )
            curr_ext = halo_mod.exchange_halo_2d(
                curr_t, warp_halo, ty=ty, tx=tx, boundary="zero"
            )
            warped = _warp_tile(
                curr_ext, u, v, warp_halo, gy0, gx0, lh, lw
            )
            if use_kernel:
                du, dv = _local_lk_pallas(
                    prev_t, warped, gy0, gx0, lh, lw, ty, tx,
                    cfg.window_size, cfg.det_threshold,
                )
            else:
                avg_ext = halo_mod.exchange_halo_2d(
                    (prev_t + warped) * 0.5, HALO, ty=ty, tx=tx,
                    boundary="symm",
                )
                it_ext = halo_mod.exchange_halo_2d(
                    prev_t - warped, HALO - 1, ty=ty, tx=tx, boundary="zero"
                )
                du, dv = _local_lk(
                    avg_ext, it_ext, gy0, gx0, lh, lw,
                    cfg.window_size, cfg.det_threshold,
                )
            u2 = jnp.where(converged, u, u + du)
            v2 = jnp.where(converged, v, v + dv)
            # Global means over all tiles (psum across the spatial axes).
            sums = lax.psum(
                jnp.stack([jnp.abs(du).sum(), jnp.abs(dv).sum()]),
                ("ty", "tx"),
            )
            npix = float(lh * lw)
            now = jnp.logical_and(
                sums[0] / npix < cfg.convergence_threshold,
                sums[1] / npix < cfg.convergence_threshold,
            )
            return u2, v2, i + 1, converged | now

        # Tie the carry's device-varying annotation to the tile data (the
        # body's halo exchange/psum makes outputs varying; the init must
        # match).
        tie = prev_t[0, 0] * 0.0
        init = (
            u + tie,
            v + tie,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False) | (tie > 1.0),
        )
        u, v, _, _ = lax.while_loop(cond, body, init)
        return u, v

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
        # pallas_call outputs carry no vma annotation inside shard_map;
        # correctness vs the single-device path is asserted numerically
        # in tests/test_sharding.py instead.
        check_vma=False,
    )
    def step(prev_l, curr_l):
        def one(prev_t, curr_t):
            # --- Distributed pyramid build (fine -> coarse) ---------
            # Local tiles for every sharded level; full (replicated)
            # arrays for the rest, built from ONE gather of the
            # coarsest sharded level.
            tiles_prev = {n_levels - 1: prev_t}
            tiles_curr = {n_levels - 1: curr_t}
            for lvl in range(n_levels - 1, first_sharded, -1):
                tiles_prev[lvl - 1] = dist_pyramid.sharded_downsample(
                    tiles_prev[lvl], dims[lvl], dims[lvl - 1], sigma,
                    ty=ty, tx=tx,
                )
                tiles_curr[lvl - 1] = dist_pyramid.sharded_downsample(
                    tiles_curr[lvl], dims[lvl], dims[lvl - 1], sigma,
                    ty=ty, tx=tx,
                )
            full_prev: dict[int, jax.Array] = {}
            full_curr: dict[int, jax.Array] = {}
            if first_sharded > 0:
                def gather(t):
                    t = lax.all_gather(t, "tx", axis=1, tiled=True)
                    return lax.all_gather(t, "ty", axis=0, tiled=True)

                full_prev[first_sharded] = gather(tiles_prev[first_sharded])
                full_curr[first_sharded] = gather(tiles_curr[first_sharded])
                for lvl in range(first_sharded, 0, -1):
                    nh, nw = dims[lvl - 1]
                    full_prev[lvl - 1] = ops.downsample_fused(
                        full_prev[lvl], nh, nw, sigma
                    )
                    full_curr[lvl - 1] = ops.downsample_fused(
                        full_curr[lvl], nh, nw, sigma
                    )

            # --- Coarse-to-fine solve -------------------------------
            from tpuflow.flow.pyramidal import _refine_level

            u = v = None  # replicated flow (full arrays)
            u_t = v_t = None  # sharded flow (local tiles)
            for lvl in range(n_levels):
                if not sharded[lvl]:
                    # Replicated level: identical solve on every device.
                    lh, lw = dims[lvl]
                    if lvl == 0:
                        u = jnp.zeros((lh, lw), jnp.float32)
                        v = jnp.zeros((lh, lw), jnp.float32)
                    else:
                        u, v = jnp_ref.upsample_flow(u, v, (lh, lw))
                    u, v, _ = _refine_level(
                        full_prev[lvl], full_curr[lvl], u, v, cfg,
                        level_backend,
                    )
                    continue
                lh, lw = dims[lvl]
                th, tw = lh // ty, lw // tx
                if lvl == 0:
                    tie = prev_t[0, 0] * 0.0
                    u_t = jnp.zeros((th, tw), jnp.float32) + tie
                    v_t = jnp.zeros((th, tw), jnp.float32) + tie
                elif not sharded[lvl - 1]:
                    # Replicated -> sharded transition: each device
                    # upsamples straight into its own tile.
                    u_t, v_t = dist_pyramid.replicated_to_sharded_upsample(
                        u, v, (lh, lw), ty=ty, tx=tx
                    )
                else:
                    u_t, v_t = dist_pyramid.sharded_upsample_flow(
                        u_t, v_t, dims[lvl - 1], (lh, lw), ty=ty, tx=tx
                    )
                u_t, v_t = refine_sharded(
                    tiles_prev[lvl], tiles_curr[lvl], u_t, v_t, lvl
                )
            return u_t, v_t

        # Static unrolled loop over the LOCAL batch instead of vmap:
        # equivalent XLA program for the serving case (local batch 1 —
        # one frame pair per data-parallel shard).
        outs = [one(prev_l[i], curr_l[i]) for i in range(prev_l.shape[0])]
        return (
            jnp.stack([o[0] for o in outs]),
            jnp.stack([o[1] for o in outs]),
        )

    sharding = NamedSharding(mesh, spec)
    frame_prev = jax.device_put(frame_prev, sharding)
    frame_curr = jax.device_put(frame_curr, sharding)
    return jax.jit(step)(frame_prev, frame_curr)
