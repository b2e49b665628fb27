"""Distributed (sharded) pyramid build + flow upsampling operators.

An earlier tiled pyramidal path all_gathered BOTH full frames per step
to build replicated coarse pyramids: per-frame traffic O(frame), the
term that dominates once devices sit on different hosts. The reference
never gathers: each
RTL pyramid_builder consumes its own stream and produces its level from
line buffers (/root/reference/rtl/unopt/pyramid_builder.sv:22-404).

This module is the sharded equivalent: the pyramid's per-axis
operators (Gaussian blur fused with linspace bilinear resampling, and
the flow upsampler) are BANDED matrices (`tpuflow.core.ops`
``_downsample_matrix_np`` / ``_resample_matrix_np`` — exact zeros
outside a ~radius-10 band for sigma=2), so a device holding a row/column
tile of a level can compute its tile of the next level from its own
rows plus a fixed halo: halo-exchange the overhang via ``ppermute``,
then apply the device's static slice of the operator with one
matmul. Per-device operator slices are precomputed as a stacked
constant and selected by ``lax.axis_index`` inside ``shard_map``.

Traffic per level build: O(halo * tile_perimeter) bytes instead of
O(frame).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tpuflow.core import ops
from tpuflow.sharding.halo import _exchange_axis


class _BandedShardPlan:
    """Static per-device decomposition of a banded (m, n) operator for
    ``n_dev`` equal row-shards of the output and column-shards of the
    input: stacked per-device operator slices (uniform width), the
    input-column start of each slice, and the halo needed to cover the
    largest overhang beyond a device's own input tile."""

    __slots__ = ("mats", "starts", "halo", "width", "mb", "nb")

    def __init__(self, d_np: np.ndarray, n_dev: int):
        m, n = d_np.shape
        assert m % n_dev == 0, f"out extent {m} must divide {n_dev} shards"
        assert n % n_dev == 0, f"in extent {n} must divide {n_dev} shards"
        mb, nb = m // n_dev, n // n_dev
        ranges = []
        for d in range(n_dev):
            blk = d_np[d * mb : (d + 1) * mb]
            nz = np.nonzero(np.abs(blk).sum(axis=0) > 0.0)[0]
            assert nz.size, "banded operator has an all-zero row block"
            ranges.append((int(nz[0]), int(nz[-1]) + 1))
        width = max(hi - lo for lo, hi in ranges)
        assert width <= n
        halo = 0
        starts, mats = [], []
        for d, (lo, hi) in enumerate(ranges):
            lo2 = max(0, min(lo, n - width))
            halo = max(halo, d * nb - lo2, (lo2 + width) - (d + 1) * nb, 0)
            starts.append(lo2)
            mats.append(d_np[d * mb : (d + 1) * mb, lo2 : lo2 + width])
        # ppermute halo exchange relays at most one whole neighbor tile.
        assert halo <= nb, f"banded halo {halo} exceeds input tile {nb}"
        self.mats = np.stack(mats)  # (n_dev, mb, width)
        self.starts = np.array(starts, np.int32)
        self.halo = int(halo)
        self.width = int(width)
        self.mb, self.nb = mb, nb


@functools.lru_cache(maxsize=None)
def _downsample_plan(n_src: int, n_dst: int, sigma: float, n_dev: int):
    return _BandedShardPlan(
        ops._downsample_matrix_np(n_src, n_dst, sigma), n_dev
    )


@functools.lru_cache(maxsize=None)
def _resample_plan(n_src: int, n_dst: int, n_dev: int):
    return _BandedShardPlan(ops._resample_matrix_np(n_src, n_dst), n_dev)


def _apply_left(plan: _BandedShardPlan, x: jax.Array, axis_name: str,
                n_dev: int) -> jax.Array:
    """Local tile of ``D @ X`` for a row-sharded X (rows on axis 0)."""
    if n_dev == 1:
        s = int(plan.starts[0])
        xs = lax.slice_in_dim(x, s, s + plan.width, axis=0)
        return lax.dot(
            jnp.asarray(plan.mats[0], x.dtype), xs,
            precision=lax.Precision.HIGHEST,
        )
    ext = x
    if plan.halo:
        # Zero boundary fill: the operator's columns never reach outside
        # [0, n) (boundary reflection is folded into the matrix), so the
        # fill is never read on edge devices.
        ext = _exchange_axis(
            x, axis_name, n_dev, plan.halo, axis=0, boundary="zero"
        )
    idx = lax.axis_index(axis_name)
    start = jnp.asarray(plan.starts)[idx] - idx * plan.nb + plan.halo
    xs = lax.dynamic_slice_in_dim(ext, start, plan.width, axis=0)
    mat = jnp.asarray(plan.mats, x.dtype)[idx]
    return lax.dot(mat, xs, precision=lax.Precision.HIGHEST)


def _apply_right(plan: _BandedShardPlan, x: jax.Array, axis_name: str,
                 n_dev: int) -> jax.Array:
    """Local tile of ``X @ D.T`` for a column-sharded X (cols on axis 1)."""
    if n_dev == 1:
        s = int(plan.starts[0])
        xs = lax.slice_in_dim(x, s, s + plan.width, axis=1)
        return lax.dot(
            xs, jnp.asarray(plan.mats[0].T, x.dtype),
            precision=lax.Precision.HIGHEST,
        )
    ext = x
    if plan.halo:
        ext = _exchange_axis(
            x, axis_name, n_dev, plan.halo, axis=1, boundary="zero"
        )
    idx = lax.axis_index(axis_name)
    start = jnp.asarray(plan.starts)[idx] - idx * plan.nb + plan.halo
    xs = lax.dynamic_slice_in_dim(ext, start, plan.width, axis=1)
    mat = jnp.asarray(plan.mats, x.dtype)[idx]
    return lax.dot(xs, mat.T, precision=lax.Precision.HIGHEST)


def sharded_downsample(
    tile: jax.Array,
    src_shape: tuple[int, int],
    dst_shape: tuple[int, int],
    sigma: float,
    *,
    ty: int,
    tx: int,
    ty_axis: str = "ty",
    tx_axis: str = "tx",
) -> jax.Array:
    """One pyramid downsampling step on a (ty, tx)-sharded image.

    ``tile`` is this device's (src_h/ty, src_w/tx) tile of the global
    ``src_shape`` image; returns the device's (dst_h/ty, dst_w/tx) tile
    of ``ops.downsample_fused(img, *dst_shape, sigma)``. Matches the
    single-device operator to f32 rounding (~1 ulp: per-device column
    windows give XLA a different contraction extent than the dense /
    256-block path — same class as ops._banded_left's documented note).
    """
    gh, gw = src_shape
    nh, nw = dst_shape
    out = _apply_left(_downsample_plan(gh, nh, sigma, ty), tile, ty_axis, ty)
    return _apply_right(_downsample_plan(gw, nw, sigma, tx), out, tx_axis, tx)


def sharded_upsample_flow(
    u: jax.Array,
    v: jax.Array,
    src_shape: tuple[int, int],
    dst_shape: tuple[int, int],
    *,
    ty: int,
    tx: int,
    ty_axis: str = "ty",
    tx_axis: str = "tx",
) -> tuple[jax.Array, jax.Array]:
    """Sharded twin of ``jnp_ref.upsample_flow`` (linspace bilinear
    resample + magnitude rescale) on (ty, tx)-sharded flow tiles."""
    ch, cw = src_shape
    th, tw = dst_shape
    rp_h = _resample_plan(ch, th, ty)
    rp_w = _resample_plan(cw, tw, tx)

    def up(f):
        out = _apply_left(rp_h, f, ty_axis, ty)
        return _apply_right(rp_w, out, tx_axis, tx)

    return up(u) * (tw / cw), up(v) * (th / ch)


@functools.lru_cache(maxsize=None)
def _row_slices(n_src: int, n_dst: int, n_dev: int) -> np.ndarray:
    """(n_dev, n_dst/n_dev, n_src) stacked row shards of the resample
    matrix — for upsampling a REPLICATED coarse field directly into
    sharded tiles (each device computes only its rows/cols)."""
    m = ops._resample_matrix_np(n_src, n_dst)
    assert n_dst % n_dev == 0
    mb = n_dst // n_dev
    return np.stack([m[d * mb : (d + 1) * mb] for d in range(n_dev)])


def replicated_to_sharded_upsample(
    u_full: jax.Array,
    v_full: jax.Array,
    dst_shape: tuple[int, int],
    *,
    ty: int,
    tx: int,
    ty_axis: str = "ty",
    tx_axis: str = "tx",
) -> tuple[jax.Array, jax.Array]:
    """Upsample a replicated (ch, cw) flow field straight into this
    device's (dst_h/ty, dst_w/tx) tile — the replicated-coarse to
    sharded-fine transition, without materializing the full fine field
    on every device."""
    ch, cw = u_full.shape
    th, tw = dst_shape
    rows = jnp.asarray(_row_slices(ch, th, ty), u_full.dtype)
    cols = jnp.asarray(_row_slices(cw, tw, tx), u_full.dtype)
    ri = lax.axis_index(ty_axis)
    ci = lax.axis_index(tx_axis)

    def up(f):
        out = lax.dot(rows[ri], f, precision=lax.Precision.HIGHEST)
        return lax.dot(out, cols[ci].T, precision=lax.Precision.HIGHEST)

    return up(u_full) * (tw / cw), up(v_full) * (th / ch)
