"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference repo tests its RTL without a board (Vivado xsim); we test
our multi-device sharding without a GPU cluster: 8 virtual CPU devices
via ``xla_force_host_platform_device_count`` (SURVEY.md §4). An
explicitly set ``JAX_PLATFORMS`` is honoured; otherwise the tests run on
the CPU. Tests marked ``gpu`` decide inside the test whether a card is
present and skip without one.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from tpuflow.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _ensure_native_ext() -> None:
    """Build tpuflow._fastio in-tree if missing so tests/test_native_io.py
    runs in a fresh checkout instead of silently skipping (the reference
    ships no native build in CI either, but our CI builds it — keep
    local pytest at parity with scripts/pre_merge_check.sh)."""
    import importlib.util
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    if importlib.util.find_spec("tpuflow._fastio") is not None:
        return
    repo = Path(__file__).resolve().parent.parent
    if not (repo / "setup.py").exists() or shutil.which("g++") is None:
        return
    try:
        subprocess.run(
            [sys.executable, "setup.py", "build_ext", "--inplace"],
            cwd=repo, check=True, capture_output=True, timeout=300,
        )
    except (subprocess.SubprocessError, OSError) as exc:
        print(f"WARNING: native extension build failed ({exc}); "
              "test_native_io will skip", file=sys.stderr)


_ensure_native_ext()


@pytest.fixture()
def rng():
    # Function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it.
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def frame_pair():
    """A deterministic textured frame pair with known 2 px horizontal shift."""
    from tpuflow.eval import patterns

    f0, f1 = patterns.generate_test_pattern(
        patterns.TEST_PATTERNS["translate_medium"], 320, 240, output_dir=None
    )
    return f0.astype(np.float32), f1.astype(np.float32)


@pytest.fixture(scope="session")
def small_frame_pair():
    """Small random textured pair for fast kernel tests."""
    rng = np.random.default_rng(99)
    base = rng.uniform(0.0, 255.0, (64, 96)).astype(np.float32)
    from scipy.ndimage import gaussian_filter, shift

    base = gaussian_filter(base, 2.0).astype(np.float32)
    shifted = shift(base, (0.0, 1.5), order=1, mode="constant").astype(np.float32)
    return base, shifted


@pytest.fixture()
def gpu():
    """The first JAX device, for tests marked ``gpu``; skips without one."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture()
def interpret():
    """Runs the fused Pallas kernel in the interpreter for the test."""
    from tpuflow.kernels import pallas_lk

    with pallas_lk.interpret_mode():
        yield
