"""Multi-device tiled dense Lucas-Kanade flow.

Shards the frame as a 2-D grid of tiles over a ("batch", "ty", "tx")
mesh (SURVEY.md §2.6 / §5 "long-context analog"): each device computes
flow for its tile after a 3-pixel halo exchange (1 px Sobel + 2 px
window apron) via ``ppermute``. Output is bit-equivalent to the
single-device jnp path (tests/test_sharding.py), including the
symmetric-boundary gradients at true image edges and the zero border /
``|det|`` gate semantics of the reference golden model
(python/lucas_kanade_core.py:100-135).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from tpuflow.sharding import halo as halo_mod

HALO = 3  # Sobel (1) + window half (2) for the default 5x5 window


def _local_lk(avg_ext, it_ext, gy0, gx0, gh, gw, window, det_threshold):
    """LK on an extended local tile.

    avg_ext: (h + 6, w + 6) averaged frame with halo; it_ext: (h + 4,
    w + 4) temporal difference with a 2 px halo; (gy0, gx0) = global
    coordinates of the tile origin; (gh, gw) = global image shape.
    """
    h = avg_ext.shape[0] - 2 * HALO
    w = avg_ext.shape[1] - 2 * HALO
    rh, rw = h + 4, w + 4  # gradient region (2 px apron)

    def sh(dy, dx):
        return lax.slice(avg_ext, (1 + dy, 1 + dx), (1 + dy + rh, 1 + dx + rw))

    ix = (
        (sh(-1, -1) - sh(-1, 1))
        + 2.0 * (sh(0, -1) - sh(0, 1))
        + (sh(1, -1) - sh(1, 1))
    ) * 0.125
    iy = (
        (sh(-1, -1) - sh(1, -1))
        + 2.0 * (sh(-1, 0) - sh(1, 0))
        + (sh(-1, 1) - sh(1, 1))
    ) * 0.125
    it = it_ext

    def wsum(a):
        rows = a[0:h, :]
        for d in range(1, window):
            rows = rows + a[d : h + d, :]
        out = lax.slice(rows, (0, 0), (h, w))
        for d in range(1, window):
            out = out + lax.slice(rows, (0, d), (h, w + d))
        return out

    s_xx = wsum(ix * ix)
    s_yy = wsum(iy * iy)
    s_xy = wsum(ix * iy)
    b0 = -wsum(ix * it)
    b1 = -wsum(iy * it)

    det = s_xx * s_yy - s_xy * s_xy
    solvable = jnp.abs(det) > det_threshold
    inv = jnp.where(solvable, 1.0 / jnp.where(solvable, det, 1.0), 0.0)
    u = (s_yy * b0 - s_xy * b1) * inv
    v = (s_xx * b1 - s_xy * b0) * inv

    half = window // 2
    rows = lax.broadcasted_iota(jnp.int32, (h, w), 0) + gy0
    cols = lax.broadcasted_iota(jnp.int32, (h, w), 1) + gx0
    interior = (
        (rows >= half) & (rows < gh - half) & (cols >= half) & (cols < gw - half)
    )
    return jnp.where(interior, u, 0.0), jnp.where(interior, v, 0.0)


def tiled_lucas_kanade_single_scale(
    frame_prev: jax.Array,
    frame_curr: jax.Array,
    mesh: Mesh,
    window_size: int = 5,
    det_threshold: float = 1e-4,
) -> tuple[jax.Array, jax.Array]:
    """Dense (u, v) flow over a ("batch", "ty", "tx")-sharded frame batch.

    Inputs are (B, H, W); B is sharded over "batch" and the spatial dims
    over ("ty", "tx"). Bit-equivalent to the single-device path.
    """
    ty = mesh.shape["ty"]
    tx = mesh.shape["tx"]
    _, gh, gw = frame_prev.shape
    assert gh % ty == 0 and gw % tx == 0, "image dims must divide the mesh tiling"
    th, tw = gh // ty, gw // tx
    assert th > 2 * HALO and tw > 2 * HALO, "tiles must exceed the halo"

    spec = P("batch", "ty", "tx")

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(spec, spec),
    )
    def step(prev_l, curr_l):
        gy0 = lax.axis_index("ty") * th
        gx0 = lax.axis_index("tx") * tw

        def one(prev, curr):
            avg = (prev + curr) * 0.5
            avg_ext = halo_mod.exchange_halo_2d(
                avg, HALO, ty=ty, tx=tx, boundary="symm"
            )
            it_ext = halo_mod.exchange_halo_2d(
                prev - curr, HALO - 1, ty=ty, tx=tx, boundary="zero"
            )
            return _local_lk(
                avg_ext, it_ext, gy0, gx0, gh, gw, window_size, det_threshold
            )

        return jax.vmap(one)(prev_l, curr_l)

    sharding = NamedSharding(mesh, spec)
    frame_prev = jax.device_put(frame_prev, sharding)
    frame_curr = jax.device_put(frame_curr, sharding)
    return jax.jit(step)(frame_prev, frame_curr)
