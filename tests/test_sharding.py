"""Multi-chip sharding tests on a virtual 8-device CPU mesh (the analog
of the reference testing RTL without a board — SURVEY.md §4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuflow.flow import lucas_kanade_single_scale
from tpuflow.sharding import make_flow_mesh, tiled_lucas_kanade_single_scale
from tpuflow.sharding.halo import exchange_halo_2d


def _need(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} devices")


def test_mesh_construction():
    _need(8)
    mesh = make_flow_mesh(batch=2, ty=2, tx=2)
    assert mesh.shape == {"batch": 2, "ty": 2, "tx": 2}
    with pytest.raises(ValueError):
        make_flow_mesh(batch=4, ty=2, tx=2)


def test_halo_exchange_matches_padding():
    """Halo-extended tiles reassemble into the symmetrically padded image."""
    _need(4)
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    import functools

    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (1, 16, 24)).astype(np.float32)
    halo = 3

    spec = P("batch", "ty", "tx")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec,), out_specs=P("batch", "ty", "tx")
    )
    def extend(x):
        return jax.vmap(
            lambda t: exchange_halo_2d(t, halo, ty=2, tx=2, boundary="symm")
        )(x)

    x = jax.device_put(jnp.asarray(img), NamedSharding(mesh, spec))
    ext = jax.jit(extend)(x)
    # Each extended tile must equal the corresponding slice of the padded
    # global image.
    padded = np.pad(img[0], halo, mode="symmetric")
    ext_np = np.asarray(ext)
    # out_specs concatenates tiles: shape (1, 2*(8+6), 2*(12+6))
    t00 = ext_np[0, : 8 + 2 * halo, : 12 + 2 * halo]
    np.testing.assert_allclose(t00, padded[: 8 + 2 * halo, : 12 + 2 * halo], atol=0)
    t11 = ext_np[0, 8 + 2 * halo :, 12 + 2 * halo :]
    np.testing.assert_allclose(t11, padded[8:, 12:], atol=0)


@pytest.mark.parametrize("tiling", [(1, 2, 2), (2, 2, 2), (1, 4, 2), (1, 1, 8)])
def test_tiled_lk_matches_single_device(tiling, rng):
    """The headline sharding gate: tiled flow == single-device flow."""
    batch, ty, tx = tiling
    _need(batch * ty * tx)
    from scipy.ndimage import gaussian_filter

    mesh = make_flow_mesh(batch=batch, ty=ty, tx=tx)
    frames = []
    for _ in range(batch):
        p = gaussian_filter(
            rng.uniform(0, 255, (48, 64)).astype(np.float32), 2.0
        ).astype(np.float32)
        c = gaussian_filter(
            rng.uniform(0, 255, (48, 64)).astype(np.float32), 2.0
        ).astype(np.float32)
        frames.append((p, c))
    prev = jnp.asarray(np.stack([f[0] for f in frames]))
    curr = jnp.asarray(np.stack([f[1] for f in frames]))

    u_t, v_t = tiled_lucas_kanade_single_scale(prev, curr, mesh)

    for b in range(batch):
        u_s, v_s = lucas_kanade_single_scale(prev[b], curr[b])
        np.testing.assert_allclose(
            np.asarray(u_t)[b], np.asarray(u_s), atol=1e-4,
            err_msg=f"tiling {tiling} batch {b} (u)",
        )
        np.testing.assert_allclose(
            np.asarray(v_t)[b], np.asarray(v_s), atol=1e-4,
            err_msg=f"tiling {tiling} batch {b} (v)",
        )


def test_tiled_lk_rejects_bad_tiling(rng):
    _need(4)
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    prev = jnp.zeros((1, 48, 63), jnp.float32)  # width does not divide tx=2
    with pytest.raises(AssertionError):
        tiled_lucas_kanade_single_scale(prev, prev, mesh)


@pytest.mark.parametrize("tiling", [(1, 2, 2), (2, 2, 2)])
def test_tiled_pyramidal_matches_single_device(tiling, rng):
    """Tiled pyramidal (replicated coarse + sharded fine) == the
    single-device fast-path semantics (backend="xla")."""
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.core.config import PyramidConfig
    from tpuflow.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal
    from scipy.ndimage import gaussian_filter, shift

    batch, ty, tx = tiling
    _need(batch * ty * tx)
    mesh = make_flow_mesh(batch=batch, ty=ty, tx=tx)
    cfg = PyramidConfig(levels=3, window_size=5, iterations=2)

    frames = []
    for i in range(batch):
        base = gaussian_filter(
            rng.uniform(0, 255, (48, 64)).astype(np.float32), 2.0
        ).astype(np.float32)
        moved = shift(base, (0.5, 1.5 + i), order=1, mode="constant").astype(
            np.float32
        )
        frames.append((base, moved))
    prev = jnp.asarray(np.stack([f[0] for f in frames]))
    curr = jnp.asarray(np.stack([f[1] for f in frames]))

    u_t, v_t = tiled_lucas_kanade_pyramidal(prev, curr, mesh, config=cfg)

    # Tolerance note: the per-tile XLA residual (tiled_flow._local_lk)
    # adds the window sums in another order than the single-device
    # solve; the refinement amplifies that rounding at a fraction of a
    # percent of pixels.
    for b in range(batch):
        u_s, v_s = lucas_kanade_pyramidal(
            prev[b], curr[b], config=cfg, backend="xla"
        )
        np.testing.assert_allclose(
            np.asarray(u_t)[b], np.asarray(u_s), atol=1e-3,
            err_msg=f"tiling {tiling} batch {b}",
        )
        np.testing.assert_allclose(
            np.asarray(v_t)[b], np.asarray(v_s), atol=1e-3,
        )


@pytest.mark.gpu
def test_tiled_pallas_matches_single_pallas(rng, gpu):
    """backend="pallas" tiled flow (per-shard fused kernel + halo
    exchange) matches the single-device kernel fast path, compiled for
    the card (also chip_smoke.py --four)."""
    from jax.sharding import Mesh

    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal

    devs = np.array(jax.devices()[:1]).reshape(1, 1, 1)
    mesh = Mesh(devs, ("batch", "ty", "tx"))
    prev = jnp.asarray(rng.uniform(0, 255, (1, 120, 160)), jnp.float32)
    curr = jnp.roll(prev, 2, axis=2)
    u_t, v_t = tiled_lucas_kanade_pyramidal(prev, curr, mesh, backend="pallas")
    u_s, v_s = lucas_kanade_pyramidal(prev[0], curr[0], backend="pallas")
    np.testing.assert_allclose(np.asarray(u_t[0]), np.asarray(u_s), atol=1e-3)
    np.testing.assert_allclose(np.asarray(v_t[0]), np.asarray(v_s), atol=1e-3)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_tiled_pallas_interpret_cpu_mesh(backend, rng, interpret):
    """The tiled fast path on a 4-device virtual CPU mesh against the
    single-device fast path: with the kernel (interpreted) inside
    shard_map for the per-shard solves and the replicated coarse levels,
    and with XLA alone."""
    from jax.sharding import Mesh

    from tpuflow.core.config import PyramidConfig
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal

    _need(4)
    devs = np.array(jax.devices()[:4]).reshape(1, 2, 2)
    mesh = Mesh(devs, ("batch", "ty", "tx"))
    cfg = PyramidConfig(levels=2, iterations=2)
    prev = jnp.asarray(rng.uniform(0, 255, (1, 80, 128)), jnp.float32)
    curr = jnp.roll(prev, 2, axis=2)
    u_t, v_t = tiled_lucas_kanade_pyramidal(
        prev, curr, mesh, config=cfg, backend=backend
    )
    u_s, v_s = lucas_kanade_pyramidal(
        prev[0], curr[0], config=cfg, backend=backend
    )
    np.testing.assert_allclose(np.asarray(u_t)[0], np.asarray(u_s), atol=1e-3)
    np.testing.assert_allclose(np.asarray(v_t)[0], np.asarray(v_s), atol=1e-3)


def test_extended_tile_pallas_lk_geometry(rng, interpret):
    """The tiled fast path's core geometry claim, tested without
    shard_map: running the kernel (zero carried flow) on a halo-extended
    tile and cropping the halo reproduces the global kernel's output
    over that tile — for interior tiles AND for global-border tiles
    (where the symm halo ring stands in for the kernel's own symm pad)."""
    from tpuflow.kernels import pallas_lk

    def residual(p, c):
        h, w = p.shape
        z = pallas_lk.pad_flow(jnp.zeros((h, w), jnp.float32))
        du, dv, _, _ = pallas_lk.refine(
            pallas_lk.pad_frame(p, 5), pallas_lk.pad_frame(c, 5), z, z,
            jnp.asarray(False), height=h, width=w,
        )
        return np.asarray(du)[:h, :w], np.asarray(dv)[:h, :w]

    gh, gw = 64, 256
    prev = jnp.asarray(rng.uniform(0, 255, (gh, gw)), jnp.float32)
    curr = jnp.asarray(rng.uniform(0, 255, (gh, gw)), jnp.float32)
    u_g, v_g = residual(prev, curr)

    ext = 3  # window half (2) + Sobel reach (1)
    # Symm-pad the global frame once; every extended tile is a slice of
    # it (what exchange_halo_2d produces with boundary="symm").
    prev_p = jnp.pad(prev, ext, mode="symmetric")
    curr_p = jnp.pad(curr, ext, mode="symmetric")

    th, tw = 32, 128
    for (y0, x0) in [(0, 0), (32, 128), (0, 128), (32, 0)]:
        pe = prev_p[y0 : y0 + th + 2 * ext, x0 : x0 + tw + 2 * ext]
        ce = curr_p[y0 : y0 + th + 2 * ext, x0 : x0 + tw + 2 * ext]
        du_e, dv_e = residual(pe, ce)
        du = du_e[ext : ext + th, ext : ext + tw]
        dv = dv_e[ext : ext + th, ext : ext + tw]
        # Reapply the global half-window border mask.
        rows = np.arange(y0, y0 + th)[:, None]
        cols = np.arange(x0, x0 + tw)[None, :]
        interior = (
            (rows >= 2) & (rows < gh - 2) & (cols >= 2) & (cols < gw - 2)
        )
        du = np.where(interior, du, 0.0)
        dv = np.where(interior, dv, 0.0)
        np.testing.assert_allclose(
            du, u_g[y0 : y0 + th, x0 : x0 + tw], atol=1e-5,
            err_msg=f"tile ({y0},{x0}) u",
        )
        np.testing.assert_allclose(
            dv, v_g[y0 : y0 + th, x0 : x0 + tw], atol=1e-5,
            err_msg=f"tile ({y0},{x0}) v",
        )


def test_tiled_narrow_vertical_matches_single_device(rng):
    """PyramidConfig.max_disp_v plumbs through the tiled path: tiled
    narrow-band output == single-device narrow-band (backend="xla")
    semantics, same gate as the full-band test."""
    from scipy.ndimage import gaussian_filter, shift

    from tpuflow.core.config import PyramidConfig
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal

    _need(4)
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    cfg = PyramidConfig(levels=3, window_size=5, iterations=2, max_disp_v=3)

    base = gaussian_filter(
        rng.uniform(0, 255, (48, 64)).astype(np.float32), 2.0
    ).astype(np.float32)
    moved = shift(base, (0.8, 1.5), order=1, mode="constant").astype(np.float32)
    prev = jnp.asarray(base[None])
    curr = jnp.asarray(moved[None])

    u_t, v_t = tiled_lucas_kanade_pyramidal(prev, curr, mesh, config=cfg)
    u_s, v_s = lucas_kanade_pyramidal(
        prev[0], curr[0], config=cfg, backend="xla"
    )
    np.testing.assert_allclose(np.asarray(u_t)[0], np.asarray(u_s), atol=1e-3)
    np.testing.assert_allclose(np.asarray(v_t)[0], np.asarray(v_s), atol=1e-3)
    # And the narrow band actually engages somewhere (clip is active).
    cfg_full = PyramidConfig(levels=3, window_size=5, iterations=2)
    u_f, v_f = lucas_kanade_pyramidal(
        prev[0], curr[0], config=cfg_full, backend="xla"
    )
    assert np.abs(np.asarray(v_f) - np.asarray(v_s)).max() > 0


# ---------------------------------------------------------------------------
# Round 5: distributed pyramid build (no full-frame all_gather)
# ---------------------------------------------------------------------------


def test_sharded_downsample_matches_single_device(rng):
    """dist_pyramid.sharded_downsample tiles reassemble into the
    single-device fused downsample (to banded-contraction rounding)."""
    import functools
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuflow.core import ops
    from tpuflow.sharding import dist_pyramid

    _need(4)
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    gh, gw = 96, 128
    nh, nw = 48, 64
    img = rng.uniform(0, 255, (1, gh, gw)).astype(np.float32)

    spec = P("batch", "ty", "tx")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec
    )
    def down(x):
        return jnp.stack([
            dist_pyramid.sharded_downsample(
                x[i], (gh, gw), (nh, nw), 2.0, ty=2, tx=2
            )
            for i in range(x.shape[0])
        ])

    x = jax.device_put(jnp.asarray(img), NamedSharding(mesh, spec))
    out = np.asarray(jax.jit(down)(x))[0]
    ref = np.asarray(ops.downsample_fused(jnp.asarray(img[0]), nh, nw, 2.0))
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_sharded_upsample_flow_matches_single_device(rng):
    import functools
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuflow.kernels import jnp_ref
    from tpuflow.sharding import dist_pyramid

    _need(4)
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    ch, cw, th, tw = 24, 32, 48, 64
    u = rng.uniform(-3, 3, (1, ch, cw)).astype(np.float32)
    v = rng.uniform(-3, 3, (1, ch, cw)).astype(np.float32)

    spec = P("batch", "ty", "tx")

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)
    )
    def up(uu, vv):
        outs = [
            dist_pyramid.sharded_upsample_flow(
                uu[i], vv[i], (ch, cw), (th, tw), ty=2, tx=2
            )
            for i in range(uu.shape[0])
        ]
        return (
            jnp.stack([o[0] for o in outs]),
            jnp.stack([o[1] for o in outs]),
        )

    sh = NamedSharding(mesh, spec)
    u_t, v_t = jax.jit(up)(
        jax.device_put(jnp.asarray(u), sh), jax.device_put(jnp.asarray(v), sh)
    )
    u_s, v_s = jnp_ref.upsample_flow(jnp.asarray(u[0]), jnp.asarray(v[0]),
                                     (th, tw))
    np.testing.assert_allclose(np.asarray(u_t)[0], np.asarray(u_s), atol=1e-4)
    np.testing.assert_allclose(np.asarray(v_t)[0], np.asarray(v_s), atol=1e-4)


@pytest.mark.parametrize("tiling", [(1, 2, 2), (2, 2, 2)])
def test_fully_distributed_pyramidal_matches_single_device(tiling, rng):
    """Every pyramid level sharded (96x128 frames, max_disp=4 so even the
    24x32 coarsest level's 12x16 tiles exceed the warp halo): the
    distributed-build path must match single-device fast-path semantics
    with NO full-frame gather."""
    from scipy.ndimage import gaussian_filter, shift

    from tpuflow.core.config import PyramidConfig
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.sharding.tiled_pyramidal import (
        _level_shapes, _shard_plan, tiled_lucas_kanade_pyramidal,
    )

    batch, ty, tx = tiling
    _need(batch * ty * tx)
    mesh = make_flow_mesh(batch=batch, ty=ty, tx=tx)
    cfg = PyramidConfig(levels=3, window_size=5, iterations=2, max_disp=4)

    # The plan must shard every level for this geometry.
    dims = _level_shapes(96, 128, cfg.levels, cfg.scale_factor)
    assert _shard_plan(dims, ty, tx, cfg.max_disp + 1) == [True] * 3

    frames = []
    for i in range(batch):
        base = gaussian_filter(
            rng.uniform(0, 255, (96, 128)).astype(np.float32), 2.0
        ).astype(np.float32)
        moved = shift(base, (0.5, 1.5 + i), order=1, mode="constant").astype(
            np.float32
        )
        frames.append((base, moved))
    prev = jnp.asarray(np.stack([f[0] for f in frames]))
    curr = jnp.asarray(np.stack([f[1] for f in frames]))

    u_t, v_t = tiled_lucas_kanade_pyramidal(prev, curr, mesh, config=cfg)

    for b in range(batch):
        u_s, v_s = lucas_kanade_pyramidal(
            prev[b], curr[b], config=cfg, backend="xla"
        )
        np.testing.assert_allclose(
            np.asarray(u_t)[b], np.asarray(u_s), atol=1e-3,
            err_msg=f"tiling {tiling} batch {b}",
        )
        np.testing.assert_allclose(
            np.asarray(v_t)[b], np.asarray(v_s), atol=1e-3,
        )


def test_fully_distributed_pyramidal_has_no_all_gather(rng):
    """The design goal, asserted on the compiled program: when every
    level shards, the step contains NO all-gather (halo ppermutes and
    convergence psums only). The r4 design all_gathered both full
    frames per step — the term that decayed its scaling model."""
    import functools
    from jax import shard_map  # noqa: F401  (parity with sibling tests)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuflow.core.config import PyramidConfig
    from tpuflow.sharding import tiled_pyramidal as tp

    _need(4)
    mesh = make_flow_mesh(batch=1, ty=2, tx=2)
    cfg = PyramidConfig(levels=3, window_size=5, iterations=2, max_disp=4)
    prev = jnp.zeros((1, 96, 128), jnp.float32)

    # Reach the inner shard_mapped step through the public entry by
    # lowering the same call the API makes.
    fn = functools.partial(
        tp.tiled_lucas_kanade_pyramidal, mesh=mesh, config=cfg
    )
    text = jax.jit(lambda a, b: fn(a, b)).lower(prev, prev).compile().as_text()
    assert "all-gather" not in text, "fully-sharded plan still gathers"


@pytest.mark.parametrize("n, backend", [(8, "xla"), (4, "pallas")])
def test_graft_dryrun_multichip(n, backend, interpret):
    """The whole multi-device step of ``__graft_entry__`` on virtual CPU
    devices: tiled flow, the fast backend inside shard_map, distributed
    BA and a mesh-tiled VO session."""
    import __graft_entry__

    _need(n)
    __graft_entry__.dryrun_multichip(n, backend=backend)


def test_graft_entry_compiles():
    import __graft_entry__

    fn, args = __graft_entry__.entry("xla")
    u, v = jax.jit(fn)(*args)
    assert u.shape == args[0].shape and np.all(np.isfinite(np.asarray(u)))
