"""tpuflow — a dense optical-flow + visual-odometry framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``rothej/optical-flow-fpga`` reference (Lucas-Kanade dense flow accelerator):

- ``tpuflow.core``     numerics that match the reference golden model's SciPy
                       semantics (symmetric-boundary convolution, Gaussian
                       smoothing, bilinear ``map_coordinates`` resampling).
- ``tpuflow.kernels``  compute kernels: pure-jnp references and the fused
                       Pallas (Triton) LK refinement kernel for the GPU.
- ``tpuflow.flow``     single-scale and pyramidal Lucas-Kanade drivers.
- ``tpuflow.sharding`` multi-device spatial tiling: mesh setup, halo
                       exchange, sharded flow.
- ``tpuflow.eval``     the 13-pattern verification harness, metrics, and
                       baseline regression gate (reference: python/
                       optical_flow_verifier.py, flow_metrics.py).
- ``tpuflow.io``       frame/flow-field IO in the reference's formats
                       (.bin / .mem / png, "x y u v" text dumps).
- ``tpuflow.vo``       visual-odometry back-end: feature tracking, pose
                       graph, distributed bundle adjustment.
"""

__version__ = "0.1.0"

__all__ = [
    "lucas_kanade_single_scale",
    "lucas_kanade_pyramidal",
    "__version__",
]


def __getattr__(name: str):
    # Lazy, so that ``tpuflow.compile_cache`` can be imported (and the
    # cache set up) before anything imports JAX.
    if name in ("lucas_kanade_single_scale", "lucas_kanade_pyramidal"):
        from tpuflow import flow

        return getattr(flow, name)
    raise AttributeError(f"module 'tpuflow' has no attribute {name!r}")
