"""Halo exchange for spatially tiled image operators.

The multi-chip analog of the reference's shared-BRAM port arbitration
(SURVEY.md §2.6): window-crossing reads at tile boundaries become
neighbor exchanges of border strips via ``jax.lax.ppermute``.
Runs inside ``shard_map``; every function here operates on the *local*
tile.

Boundary semantics: interior tile edges receive neighbor data; true
image edges are filled locally — either symmetric reflection (matching
``scipy.signal.convolve2d(boundary="symm")``, the gradient-stage
boundary) or zeros (for operators whose border output is discarded).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _shift_from_prev(block, axis_name, n):
    """Each device receives ``block`` from its predecessor along
    ``axis_name`` (device i gets device i-1's block); device 0 gets
    zeros."""
    perm = [(i, i + 1) for i in range(n - 1)]
    return lax.ppermute(block, axis_name, perm)


def _shift_from_next(block, axis_name, n):
    """Each device receives ``block`` from its successor; device n-1
    gets zeros."""
    perm = [(i + 1, i) for i in range(n - 1)]
    return lax.ppermute(block, axis_name, perm)


def _exchange_axis(x, axis_name, n, halo, axis, boundary):
    """Extend local tile by ``halo`` on both sides of ``axis`` with
    neighbor data (interior) or boundary fill (image edges)."""
    if axis == 0:
        lo_edge = x[:halo]
        hi_edge = x[-halo:]
    else:
        lo_edge = x[:, :halo]
        hi_edge = x[:, -halo:]

    # Neighbor strips: my top halo is my predecessor's bottom edge.
    from_prev = _shift_from_prev(hi_edge, axis_name, n)
    from_next = _shift_from_next(lo_edge, axis_name, n)

    idx = lax.axis_index(axis_name)
    if boundary == "symm":
        lo_fill = jnp.flip(lo_edge, axis=axis)
        hi_fill = jnp.flip(hi_edge, axis=axis)
    else:
        lo_fill = jnp.zeros_like(lo_edge)
        hi_fill = jnp.zeros_like(hi_edge)

    top = jnp.where(idx == 0, lo_fill, from_prev)
    bot = jnp.where(idx == n - 1, hi_fill, from_next)
    return jnp.concatenate([top, x, bot], axis=axis)


@partial(jax.named_call, name="exchange_halo_2d")
def exchange_halo_2d(
    x: jax.Array,
    halo: int,
    *,
    ty_axis: str = "ty",
    tx_axis: str = "tx",
    ty: int = 1,
    tx: int = 1,
    boundary: str = "symm",
) -> jax.Array:
    """Extend a local (h, w) tile to (h + 2*halo, w + 2*halo).

    Columns are exchanged first and rows second, on the widened tile, so
    corner halos arrive already containing the diagonal neighbor's data
    (relayed through the vertical neighbor — two hops, no explicit
    diagonal sends).
    """
    x = _exchange_axis(x, tx_axis, tx, halo, axis=1, boundary=boundary)
    x = _exchange_axis(x, ty_axis, ty, halo, axis=0, boundary=boundary)
    return x
