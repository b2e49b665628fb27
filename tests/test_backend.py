"""The backend resolver and the compile-cache helper."""

import os

import jax
import pytest

from tpuflow import compile_cache
from tpuflow.flow import backend


def test_fast_backend_resolves_or_refuses():
    """On a GPU the resolver names the fast backend; anywhere else it
    refuses instead of falling back to the CPU."""
    if jax.devices()[0].platform == "gpu":
        assert backend.fast_backend() == backend.GPU_FAST_BACKEND
    else:
        with pytest.raises(RuntimeError, match="GPU is required"):
            backend.fast_backend()


def test_require_gpu_names_the_device():
    if jax.devices()[0].platform == "gpu":
        assert backend.require_gpu() is jax.devices()[0]
    else:
        with pytest.raises(RuntimeError, match="does not fall back"):
            backend.require_gpu()


@pytest.mark.parametrize(
    "name, clamped", [("jnp", False), ("xla", True), ("pallas", True)]
)
def test_is_clamped(name, clamped):
    assert backend.is_clamped(name) is clamped


@pytest.mark.parametrize("name", ["mosaic", "rtl", ""])
def test_unknown_backend_rejected(name):
    with pytest.raises(ValueError, match="unknown backend"):
        backend.is_clamped(name)


def test_gpu_fast_backend_is_a_fast_backend():
    assert backend.GPU_FAST_BACKEND in backend.BACKENDS
    assert backend.is_clamped(backend.GPU_FAST_BACKEND)


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.CACHE_ENV, str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert os.environ[compile_cache.CACHE_ENV] == str(tmp_path)


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_ENV, raising=False)
    path = compile_cache.setup_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert os.environ[compile_cache.CACHE_ENV] == path
    assert jax.config.jax_compilation_cache_dir == path
