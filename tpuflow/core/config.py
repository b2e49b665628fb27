"""Pyramid / solver configuration.

Mirrors the named pyramid configurations of the reference verifier
(reference: python/verification_config.yaml:78-103) so that users of the
reference can select the same ``default / shallow / deep / large_window``
configs by name.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Static configuration for pyramidal Lucas-Kanade.

    All fields are static (Python ints/floats) so a config hashes cleanly
    into a jitted function's static arguments.
    """

    levels: int = 3
    window_size: int = 5
    iterations: int = 3
    scale_factor: float = 0.5
    # Early-exit threshold on the mean |residual| per component
    # (reference: python/lucas_kanade_pyramidal.py:221-223).
    convergence_threshold: float = 0.01
    # Texture gate on the structure-tensor determinant
    # (reference: python/lucas_kanade_core.py:131).
    det_threshold: float = 1e-4
    # Fast-path (tpuflow.flow.backend) per-level flow saturation in pixels —
    # the analog of the RTL's S8.7 +-8 px solver clamp
    # (rtl/unopt/flow_solver.sv:134-144). Inactive for motions within the
    # band, where the fast path matches the parity path exactly. The jnp
    # parity path never clamps (golden-model semantics).
    max_disp: int = 8
    # Optional narrower *vertical* saturation band for the fast path:
    # carried vertical flow saturates at +-max_disp_v (like the RTL's
    # clamp, but asymmetric). For horizontally-dominant motion this
    # clamps only untextured-region LK noise, which measured *slightly
    # better* suite metrics (the clamp regularizes garbage vectors).
    # None = max_disp (full parity-band behavior).
    max_disp_v: int | None = None
    # Adaptive per-level vertical band (fast backends only):
    # ascending candidate bands, e.g. (3, 8). At each level boundary the
    # coarse level's solved flow — already upsampled to the new level —
    # picks the narrowest candidate whose clamp would be inactive on the
    # masked interior (border-margin excluded: warp-OOB/clamp garbage
    # there is what broke the earlier global-max dispatch, DESIGN.md §3),
    # and ``lax.switch`` dispatches one of the compiled refine variants,
    # executing exactly one per level per frame. The coarsest
    # level (tiny, cheap) always runs the full band. None = static band
    # (``max_disp_v`` everywhere).
    adaptive_v_bands: tuple[int, ...] | None = None
    # A candidate band b is rejected if more than this fraction of
    # interior pixels carry |v| > b - 1 (the 1 px headroom absorbs
    # within-level residual growth). Fraction-based so a handful of
    # outlier vectors anywhere cannot force the wide band, while any
    # real moving region (>0.5% of the frame) still does.
    adaptive_v_frac: float = 0.005
    description: str = ""

    def __post_init__(self):
        if self.adaptive_v_bands is not None:
            bands = tuple(int(b) for b in self.adaptive_v_bands)
            if len(bands) < 2 or list(bands) != sorted(set(bands)):
                raise ValueError(
                    f"adaptive_v_bands must be >=2 strictly ascending ints, got {bands}"
                )
            if bands[-1] > self.max_disp:
                raise ValueError(
                    f"adaptive_v_bands max {bands[-1]} exceeds max_disp {self.max_disp}"
                )
            object.__setattr__(self, "adaptive_v_bands", bands)

    @property
    def max_disp_v_effective(self) -> int:
        return self.max_disp if self.max_disp_v is None else self.max_disp_v


# Named configurations, mirroring verification_config.yaml:78-103.
PYRAMID_CONFIGS: dict[str, PyramidConfig] = {
    "default": PyramidConfig(
        levels=3, window_size=5, iterations=3,
        description="3-level pyramid, 5x5 window, 3 iterations/level",
    ),
    "shallow": PyramidConfig(
        levels=2, window_size=5, iterations=3,
        description="2-level pyramid (faster, less memory)",
    ),
    "deep": PyramidConfig(
        levels=4, window_size=5, iterations=3,
        description="4-level pyramid (handles larger motion)",
    ),
    "large_window": PyramidConfig(
        levels=3, window_size=7, iterations=3,
        description="3-level pyramid, 7x7 window",
    ),
    # Production fast-path config for horizontally-dominant motion
    # (vehicle-mounted / scanline cameras): vertical saturation band
    # narrowed to +-3 px. Accuracy impact is confined to patterns with
    # |v| > 3 (see docs/verification_results_fast.md).
    "narrow_vertical": PyramidConfig(
        levels=3, window_size=5, iterations=3, max_disp_v=3,
        description="3-level pyramid, vertical flow band narrowed to +-3 px",
    ),
    # Adaptive production config: runs at the narrow band's rate on
    # horizontally-dominant streams but widens to the full band whenever
    # the coarse-level solve sees real vertical motion — translate_
    # vertical-class inputs keep full-band accuracy instead of silently
    # saturating at +-3 (the static narrow band's failure mode,
    # docs/verification_results_fast.md).
    "adaptive_vertical": PyramidConfig(
        levels=3, window_size=5, iterations=3, adaptive_v_bands=(3, 8),
        description="3-level pyramid, per-level vertical band selected "
        "from the coarse solve (3 or 8 px)",
    ),
    # The serving config: the adaptive vertical band ladder. On
    # streams whose coarse-level interior |v| stays under 1 px for
    # >99.5% of pixels (the select rule's b-1 headroom) the finer levels
    # run at +-2; real vertical motion escalates to +-3 or the full +-8.
    # +-1 is deliberately NOT in the ladder: its headroom predicate
    # would be frac(|v| > 0), which every stream fails (LK texture noise
    # is nonzero everywhere — measured 100% of interior pixels on the
    # bench stream), so it could only ever be selected by weakening the
    # headroom below 1 px, which would clamp real sub-pixel motion.
    "production": PyramidConfig(
        levels=3, window_size=5, iterations=3, adaptive_v_bands=(2, 3, 8),
        description="adaptive vertical band ladder (2, 3 or 8 px)",
    ),
}
