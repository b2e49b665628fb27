"""The flow backends, and the one place that picks the fast one.

- ``"jnp"``: reference-parity semantics (the golden model's flow, never
  clamped). The library default.
- ``"xla"``: fast-path semantics compiled by XLA: per-level saturation
  of the carried flow at ``+-max_disp`` (vertically ``+-max_disp_v``,
  the RTL solver clamp's analog, rtl/unopt/flow_solver.sv:134-144) and
  the adaptive vertical band ladder of configs that set one. Runs on any
  device; the tiled multi-device path has the same contract.
- ``"pallas"``: the same semantics, with the refinement step's LK chain
  in one fused Pallas kernel compiled through Triton
  (``tpuflow.kernels.pallas_lk``). GPU only, outside of tests that run
  the kernel in interpret mode.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Literal

if TYPE_CHECKING:
    import jax

Backend = Literal["jnp", "xla", "pallas"]
BACKENDS: tuple[str, ...] = ("jnp", "xla", "pallas")

# The fast backend on a GPU. The fused kernel is kept only while it
# beats XLA's fusion of the same body end to end on the card (PERF.md,
# "Bring-up findings").
GPU_FAST_BACKEND: Backend = "pallas"


def require_gpu() -> "jax.Device":
    """The first device, which must be a GPU.

    Measurement paths call this so that a run without a card fails
    instead of timing the CPU.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, but JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this path does not fall back to the CPU"
        )
    return dev


def fast_backend() -> Backend:
    """The fast-path backend for this process's GPU (fails without one)."""
    require_gpu()
    return GPU_FAST_BACKEND


def is_clamped(backend: str) -> bool:
    """Whether ``backend`` runs fast-path (saturating) semantics."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose one of {BACKENDS}")
    return backend != "jnp"
