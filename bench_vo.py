#!/usr/bin/env python3
"""Composed-VO serving step on one GPU: per-frame host time.

The full on-device tracking step (dense pyramidal flow + track advance
+ loss detection + keyframe reseeding, ``tpuflow.vo.device_loop``) runs
as one ``lax.scan`` over a device-resident frame chunk: one dispatch,
no per-frame host syncs. Prints ONE JSON line: host-clock time of the
chunk around ``block_until_ready`` divided by its length, with the
device record beside it.

    python bench_vo.py [--height 480 --width 640 --fb-check 1.0]

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

    import jax
    import jax.numpy as jnp

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.eval.chip import device_record, shifted, textured_frame
    from tpuflow.flow.backend import fast_backend
    from tpuflow.vo.pipeline import OdometrySession

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grid-step", type=int, default=16)
    parser.add_argument("--fb-check", type=float, default=None,
                        help="also run the forward-backward culling flow "
                        "(roughly doubles flow work per frame)")
    parser.add_argument("--pyramid-config", type=str, default="production",
                        choices=sorted(PYRAMID_CONFIGS))
    args = parser.parse_args()

    backend = fast_backend()
    h, w = args.height, args.width
    base = textured_frame(h, w, args.seed)
    chunk = jax.device_put(jnp.asarray(np.stack(
        [shifted(base, 0.0, 1.5 * k) for k in range(1, args.frames + 1)]
    )))
    sess = OdometrySession(
        (float(w), float(w), w / 2.0, h / 2.0),
        grid_step=args.grid_step, backend=backend,
        fb_check_threshold=args.fb_check,
        pyramid_config=args.pyramid_config,
    )
    sess.start(base)
    state0 = sess._dev
    fe = sess._fe

    t0 = time.perf_counter()
    jax.block_until_ready(fe.scan_steps(state0, chunk))
    first_call_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(fe.scan_steps(state0, chunk))
        times.append((time.perf_counter() - t0) / args.frames)
    ms = np.asarray(times) * 1e3
    suffix = "_fb" if args.fb_check is not None else ""
    print(json.dumps({
        "metric": f"vo_serving_{w}x{h}_{args.pyramid_config}{suffix}_ms_per_frame",
        "value": float(np.median(ms)),
        "unit": "ms",
        "runs_ms": [float(x) for x in ms],
        "backend": backend,
        "first_call_s": first_call_s,
        "device": device_record(),
    }))


if __name__ == "__main__":
    main()
