"""Fused Lucas-Kanade refinement step: Pallas through Triton.

One refinement iteration of the coarse-to-fine solve (reference
python/lucas_kanade_pyramidal.py:201-223) minus the warp:

    average -> Sobel -> It -> five gradient products -> window sums
    -> Cramer solve -> interior mask -> clip / latch / accumulate

plus the |du|, |dv| partial sums of the early-exit test. Left to XLA,
that chain materialises gradient and product planes between fusions;
here each program keeps it in registers, reads the two frames and the
carried flow once, and writes only the new flow and one partial-sum
vector.

Each program owns a (block_rows, block_cols) output block and walks its
rows top to bottom, like the RTL's line buffers
(rtl/unopt/window_accumulator.sv): per step it loads one new padded row
of both frames at ``window + 2`` column offsets, carries the two
previous averaged rows and the window's running vertical sums in
registers, and emits one output row. Blocks run in no order, so nothing
carries across the grid; XLA sums the per-block partials.

Numerics follow ``jnp_ref``: the same Sobel taps in the same order, the
same Cramer solve and det gate. The window sums add the same terms with
rows and columns swapped (each row's horizontal sum first, then the
vertical sum of those), so results agree with ``jnp_ref`` to float32
rounding, not bit for bit.

Inputs are padded once by :func:`pad_frame` / :func:`pad_flow` so that
every load is in bounds (the symmetric ring the reference's
``convolve2d(boundary="symm")`` needs, zeros beyond).
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Output blocks, largest first. The row loop is latency-bound, so a
# level takes the largest block that still gives about eight programs
# per SM of a 132-SM H100; smaller levels fall back to the smallest.
# One warp per program, a 3-stage load pipeline and two rows per loop
# step were fastest at every level width from 480 to 3840 in a sweep of
# block shape, warps, stages and unrolling on an H100 (PERF.md).
_BLOCKS = ((32, 128), (16, 128), (16, 64), (8, 128), (8, 64))
_MIN_PROGRAMS = 1000
NUM_WARPS = 1
NUM_STAGES = 3
UNROLL = 2


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(h: int, w: int) -> tuple[int, int]:
    """(block_rows, block_cols) for an (h, w) level."""
    for rows, cols in _BLOCKS:
        if _round_up(h, rows) // rows * (_round_up(w, cols) // cols) >= _MIN_PROGRAMS:
            return rows, cols
    return _BLOCKS[-1]


def _offset(window: int) -> int:
    """Pad rows/cols before image row/col 0: Sobel (1) + window half."""
    return window // 2 + 1


def flow_shape(h: int, w: int) -> tuple[int, int]:
    """Shape of a flow plane padded to whole output blocks."""
    block_rows, block_cols = _geometry(h, w)
    return _round_up(h, block_rows), _round_up(w, block_cols)


def pad_frame(frame: jax.Array, window: int) -> jax.Array:
    """(H, W) frame -> the padded plane the kernel loads from.

    One symmetric ring (the reference's Sobel boundary) then zeros, out
    to whole blocks plus the window's apron on every side.
    """
    h, w = frame.shape
    hq, wq = flow_shape(h, w)
    off = _offset(window)
    f = jnp.pad(frame, 1, mode="symmetric")
    return jnp.pad(f, ((off - 1, hq - h + off - 1), (off - 1, wq - w + off - 1)))


def pad_flow(flow: jax.Array) -> jax.Array:
    """(H, W) flow -> zero-padded to whole output blocks."""
    h, w = flow.shape
    hq, wq = flow_shape(h, w)
    return jnp.pad(flow, ((0, hq - h), (0, wq - w)))


def _refine_kernel(prev_ref, warp_ref, u_ref, v_ref, conv_ref,
                   uo_ref, vo_ref, sdu_ref, sdv_ref, *,
                   height: int, width: int, window: int,
                   det_threshold: float, max_disp: float, max_disp_v: float,
                   block_rows: int, block_cols: int):
    half = window // 2
    n_off = window + 2  # averaged-frame columns c-half-1 .. c+half+1
    r0 = pl.program_id(0) * block_rows
    c0 = pl.program_id(1) * block_cols
    cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (block_cols,), 0)
    col_in = (cols >= half) & (cols < width - half)
    frozen = conv_ref[0] > 0

    def load_row(t):
        """Averaged frame at n_off column offsets and It at the window's
        2*half+1 offsets, for image row t (padded row t + offset)."""
        pr = t + _offset(window)
        p = [prev_ref[pr, pl.ds(c0 + k, block_cols)] for k in range(n_off)]
        c = [warp_ref[pr, pl.ds(c0 + k, block_cols)] for k in range(n_off)]
        avg = [(pk + ck) / 2.0 for pk, ck in zip(p, c)]
        it = [p[k] - c[k] for k in range(1, n_off - 1)]
        return avg, it

    def row_sums(a_m, a_0, a_p, it):
        """Horizontal window sums of the five products on one gradient
        row, from averaged rows above/at/below it (jnp_ref's Sobel: the
        flipped 3x3 taps added row by row)."""
        sums = None
        for j in range(window):
            k = j + 1
            ix = (0.125 * a_m[k - 1] + -0.125 * a_m[k + 1]
                  + 0.25 * a_0[k - 1] + -0.25 * a_0[k + 1]
                  + 0.125 * a_p[k - 1] + -0.125 * a_p[k + 1])
            iy = (0.125 * a_m[k - 1] + 0.25 * a_m[k] + 0.125 * a_m[k + 1]
                  + -0.125 * a_p[k - 1] + -0.25 * a_p[k] + -0.125 * a_p[k + 1])
            t = it[j]
            prods = (ix * ix, iy * iy, ix * iy, ix * t, iy * t)
            sums = prods if sums is None else tuple(
                s + q for s, q in zip(sums, prods)
            )
        return sums

    def step(g, carry, emit: bool):
        """Gradient row g enters the window; emits output row g - half."""
        a_m, a_0, it_0, parts, acc_u, acc_v = carry
        a_p, it_p = load_row(g + 1)
        h_new = row_sums(a_m, a_0, a_p, it_0)
        # parts[k][j]: sum of the last j+1 gradient rows' product k,
        # added oldest first; the full window is parts[k][-1] + h_new.
        full = [parts[k][-1] + h_new[k] for k in range(5)]
        parts = [
            [h_new[k]] + [parts[k][j] + h_new[k] for j in range(window - 2)]
            for k in range(5)
        ]
        if emit:
            s_xx, s_yy, s_xy, s_xt, s_yt = full
            det = s_xx * s_yy - s_xy * s_xy
            b0 = -s_xt
            b1 = -s_yt
            solvable = jnp.abs(det) > det_threshold
            safe = jnp.where(solvable, det, 1.0)
            y = g - half
            inside = col_in & (y >= half) & (y < height - half) & solvable
            du = jnp.where(inside, (s_yy * b0 - s_xy * b1) / safe, 0.0)
            dv = jnp.where(inside, (s_xx * b1 - s_xy * b0) / safe, 0.0)
            u_c = jnp.clip(u_ref[y, pl.ds(c0, block_cols)], -max_disp, max_disp)
            v_c = jnp.clip(
                v_ref[y, pl.ds(c0, block_cols)], -max_disp_v, max_disp_v
            )
            uo_ref[y, pl.ds(c0, block_cols)] = jnp.where(frozen, u_c, u_c + du)
            vo_ref[y, pl.ds(c0, block_cols)] = jnp.where(frozen, v_c, v_c + dv)
            acc_u = acc_u + jnp.abs(du)
            acc_v = acc_v + jnp.abs(dv)
        return a_0, a_p, it_p, parts, acc_u, acc_v

    g0 = r0 - half
    a_m, _ = load_row(g0 - 1)
    a_0, it_0 = load_row(g0)
    zero = jnp.zeros((block_cols,), jnp.float32)
    parts = [[zero] * (window - 1) for _ in range(5)]
    carry = (a_m, a_0, it_0, parts, zero, zero)
    # The first 2*half rows only fill the window; the rest emit.
    carry = jax.lax.fori_loop(
        g0, g0 + 2 * half, functools.partial(step, emit=False), carry
    )

    def emit_steps(i, carry):
        for k in range(UNROLL):
            carry = step(g0 + 2 * half + i * UNROLL + k, carry, emit=True)
        return carry

    carry = jax.lax.fori_loop(0, block_rows // UNROLL, emit_steps, carry)
    sdu_ref[...] = carry[4]
    sdv_ref[...] = carry[5]


_interpret = False


@contextlib.contextmanager
def interpret_mode():
    """Run :func:`refine` in the Pallas interpreter, on any device,
    instead of compiling it for the GPU through Triton: for tests and
    rehearsals on the CPU.

    The switch is read when a caller is traced, so enter it before the
    first call of any jitted function that reaches the kernel.
    """
    global _interpret
    previous, _interpret = _interpret, True
    try:
        yield
    finally:
        _interpret = previous


def refine(
    prev_p: jax.Array,
    warped_p: jax.Array,
    flow_u: jax.Array,
    flow_v: jax.Array,
    converged: jax.Array,
    *,
    height: int,
    width: int,
    window_size: int = 5,
    det_threshold: float = 1e-4,
    max_disp: float = 8.0,
    max_disp_v: float = 8.0,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One fused refinement accumulate on padded planes.

    ``prev_p``/``warped_p`` come from :func:`pad_frame`, ``flow_u``/
    ``flow_v`` from :func:`pad_flow` (or a previous call). The carried
    flow is clipped to ``+-max_disp`` (vertically ``+-max_disp_v``) and,
    unless ``converged``, the residual LK flow between ``prev`` and the
    warped frame is added. Returns ``(u_next, v_next, sum|du|,
    sum|dv|)`` with the flow still padded. Composes with ``jax.vmap``.
    Compiles for the GPU through Triton, or runs interpreted inside
    :func:`interpret_mode`.
    """
    return _refine(
        prev_p, warped_p, flow_u, flow_v, converged, height=height,
        width=width, window_size=window_size, det_threshold=det_threshold,
        max_disp=float(max_disp), max_disp_v=float(max_disp_v),
        interpret=_interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "height", "width", "window_size", "det_threshold", "max_disp",
        "max_disp_v", "interpret",
    ),
)
def _refine(prev_p, warped_p, flow_u, flow_v, converged, *, height, width,
            window_size, det_threshold, max_disp, max_disp_v, interpret):
    if window_size % 2 != 1 or window_size < 3:
        raise ValueError(f"window_size must be odd and >= 3, got {window_size}")
    hq, wq = flow_shape(height, width)
    off = _offset(window_size)
    if prev_p.shape != (hq + 2 * off, wq + 2 * off) or flow_u.shape != (hq, wq):
        raise ValueError(
            f"padded shapes {prev_p.shape}/{flow_u.shape} do not match a "
            f"{height}x{width} frame; use pad_frame/pad_flow"
        )
    block_rows, block_cols = _geometry(height, width)
    grid = (hq // block_rows, wq // block_cols)
    kernel = functools.partial(
        _refine_kernel, height=height, width=width, window=window_size,
        det_threshold=det_threshold, max_disp=float(max_disp),
        max_disp_v=float(max_disp_v), block_rows=block_rows,
        block_cols=block_cols,
    )
    whole = pl.BlockSpec()
    part = pl.BlockSpec((None, block_cols), lambda i, j: (i, j))
    conv = jnp.reshape(converged, (1,)).astype(jnp.int32)
    u2, v2, sdu, sdv = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[whole] * 5,
        out_specs=(whole, whole, part, part),
        out_shape=(
            jax.ShapeDtypeStruct((hq, wq), jnp.float32),
            jax.ShapeDtypeStruct((hq, wq), jnp.float32),
            jax.ShapeDtypeStruct((grid[0], wq), jnp.float32),
            jax.ShapeDtypeStruct((grid[0], wq), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        # Each program reads a flow element before it writes it, and no
        # other program touches it, so the flow is updated in place.
        input_output_aliases={2: 0, 3: 1},
        interpret=interpret,
        name="lk_refine",
    )(prev_p, warped_p, flow_u, flow_v, conv)
    return u2, v2, jnp.sum(sdu), jnp.sum(sdv)
