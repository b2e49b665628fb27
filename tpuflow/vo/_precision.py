"""Exact-f32 matmul pinning for the VO/VI solver stack.

On a GPU, JAX's default matmul precision may run f32 matmuls as TF32
(10-bit mantissa) on the tensor cores; ``Precision.HIGHEST`` keeps
them true f32. For the dense-flow operators that is pinned per-op in
tpuflow.core.ops (SciPy parity needs it); the VO back-end's
Gauss-Newton solvers need it too: reduced-precision GN steps walk a
different iteration path through the convergence-gated solve, and an
accelerator's trajectories then drift far outside any cross-platform
gate vs the CPU-captured baseline. The matrices involved are tiny (3x3
rotations, 6Kx6K dense systems for small K), so HIGHEST precision
costs nothing measurable (see eval/vo_verifier.py platform-provenance
notes).

Reference mechanism being kept honest: the committed-baseline
regression gate of /root/reference/python/optical_flow_verifier.py:586-634,
extended to trajectories.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, TypeVar

import jax

F = TypeVar("F", bound=Callable[..., Any])


def pin_matmul_precision(fn: F) -> F:
    """Run (and trace) ``fn`` under HIGHEST matmul precision.

    Apply UNDER ``jax.jit`` (i.e. closest to the function) so the
    context is active while the body is traced.
    """

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped  # type: ignore[return-value]
