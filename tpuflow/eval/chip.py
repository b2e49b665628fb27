"""Helpers shared by the scripts that run on the GPU: the device record
printed beside every number, and seeded synthetic frames.

Frames are made from a seed with numpy and scipy only: a Gaussian-
filtered noise texture rounded to integer gray levels (an 8-bit camera's
values), shifted sub-pixel with ``scipy.ndimage.shift``.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of JAX's devices, plus the card's power
    limit: what every reported number is stamped with."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "jax": jax.__version__,
        "nvidia_smi": nvidia_smi(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def textured_frame(h: int, w: int, seed: int, sigma: float = 2.0) -> np.ndarray:
    """(h, w) float32 texture with integer gray levels in [0, 255]."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.0, 255.0, (h, w))
    tex = gaussian_filter(noise, sigma)
    # Stretch the blurred texture back to the full gray range.
    tex = (tex - tex.min()) / max(float(np.ptp(tex)), 1e-6) * 255.0
    return np.round(tex).astype(np.float32)


def shifted(frame: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """``frame`` moved by (dy, dx) px: frame_out(y, x) = frame(y-dy, x-dx),
    so flow from ``frame`` to the result is (u, v) = (dx, dy)."""
    from scipy.ndimage import shift

    out = shift(frame, (dy, dx), order=3, mode="nearest")
    return np.clip(out, 0.0, 255.0).astype(np.float32)
