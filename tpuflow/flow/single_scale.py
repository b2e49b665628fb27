"""Single-scale Lucas-Kanade dense flow.

JAX equivalent of the reference's single-scale path — both the Python
golden model (python/lucas_kanade_core.py:48-70) and the RTL streaming
pipeline frame_buffer -> gradient_compute -> window_accumulator ->
flow_solver (rtl/unopt/optical_flow_top.sv:16-160), as XLA-fused jnp
ops. Single-scale is off the serving path, so it has one implementation.
"""

from __future__ import annotations

import jax

from tpuflow.kernels import jnp_ref


def lucas_kanade_single_scale(
    frame_prev: jax.Array,
    frame_curr: jax.Array,
    window_size: int = 5,
    *,
    det_threshold: float = 1e-4,
    gaussian_weights: bool = False,
    return_confidence: bool = False,
):
    """Dense (u, v) flow between two grayscale float32 frames.

    Matches reference python/lucas_kanade_core.py:48-70 semantics: Sobel/8
    gradients on the averaged frame, unweighted ``window_size`` x
    ``window_size`` structure-tensor sums, Cramer solve gated on
    ``|det| > det_threshold``, zero flow on the window border.

    ``return_confidence=True`` adds a per-pixel |det| plane (structure-
    tensor conditioning — high on texture, zero on the border and flat
    regions); useful for track weighting and validity masking
    downstream.
    """
    ix, iy, it = jnp_ref.compute_gradients(frame_prev, frame_curr)
    return jnp_ref.lucas_kanade_from_gradients(
        ix,
        iy,
        it,
        window_size=window_size,
        det_threshold=det_threshold,
        gaussian_weights=gaussian_weights,
        return_confidence=return_confidence,
    )
