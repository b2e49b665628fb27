#!/usr/bin/env python3
"""Pyramidal Lucas-Kanade flow stream on one GPU: per-frame host time.

Streams seeded frames through ``lucas_kanade_pyramidal_step`` (each
frame's pyramid is built once and carried to the next pair) with the
resolved fast backend, and prints ONE JSON line: the median per-frame
time on the host clock around ``block_until_ready``, with the device
record (kind, count, power limit) beside it.

Every pair carries the same sub-pixel motion, so every level's
refinement loop does real work. Frames are on the device before timing.

    python bench.py [--height 1080 --width 1920 --config production]

Fails without a GPU; it never times the CPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpuflow.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import numpy as np  # noqa: E402


def main() -> None:
    import argparse
    import functools

    import jax

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.eval.chip import device_record, shifted, textured_frame
    from tpuflow.flow import lucas_kanade_pyramidal_step
    from tpuflow.flow.backend import fast_backend
    from tpuflow.kernels import jnp_ref

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--config", type=str, default="production",
        choices=sorted(PYRAMID_CONFIGS),
    )
    args = parser.parse_args()

    backend = fast_backend()
    h, w = args.height, args.width
    cfg = PYRAMID_CONFIGS[args.config]
    base = textured_frame(h, w, args.seed)
    frames = [
        jax.device_put(shifted(base, 0.0, 1.7 * k)) for k in range(args.frames)
    ]
    step = jax.jit(
        functools.partial(lucas_kanade_pyramidal_step, cfg=cfg, backend=backend)
    )
    pyr = jax.jit(
        lambda f: jnp_ref.build_gaussian_pyramid(f, cfg.levels, cfg.scale_factor)
    )(frames[0])
    t0 = time.perf_counter()
    jax.block_until_ready(step(pyr, frames[1]))
    compile_s = time.perf_counter() - t0

    times = []
    for f in frames[1:]:
        t0 = time.perf_counter()
        u, v, pyr = step(pyr, f)
        jax.block_until_ready((u, v))
        times.append(time.perf_counter() - t0)
    ms = np.asarray(times) * 1e3
    print(json.dumps({
        "metric": f"pyramidal_lk_{w}x{h}_{args.config}_ms_per_frame",
        "value": float(np.median(ms)),
        "unit": "ms",
        "p10": float(np.quantile(ms, 0.1)),
        "p90": float(np.quantile(ms, 0.9)),
        "frames": len(times),
        "backend": backend,
        "first_call_s": compile_s,
        "device": device_record(),
    }))


if __name__ == "__main__":
    main()
