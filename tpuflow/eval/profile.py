"""Per-stage latency of the flow pipeline on one GPU.

The reference's "profiler" is Vivado timing/utilization reports plus an
analytical pipeline-latency model in the testbench
(tb_optical_flow_top.sv:118-129; SURVEY.md §5). Here:

- each stage alone: host-clock median around ``block_until_ready``
  (after a warm-up call) and the device time of its kernels, read from a
  ``jax.profiler`` trace;
- the clamped XLA warp alone at every pyramid level's shape (device
  time), the evidence a hand-written warp would have to beat;
- the serving stream, per frame, for both fast backends in the order
  xla, pallas, pallas, xla: on a benign stream (sub-pixel horizontal
  motion of a seeded texture) and an adversarial one (unrelated noise
  frames, which select the widest band and never converge early). Each
  row gives the host-clock median per frame with a wait after every
  frame, the mean per frame when the host waits only at the end
  (dispatch runs ahead), and the device busy time per frame.

Every row carries the device record (kind, count, power limit).

    python -m tpuflow.eval.profile [--height 1080 --width 1920] [--json PATH]

Fails without a GPU; it never times the CPU.
"""

from __future__ import annotations

import functools
import time

import numpy as np



def host_ms(fn, *args, n: int = 20) -> float:
    """Median host-clock ms of ``fn(*args)`` to ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def device_ms(fn, *args, n: int = 10) -> float:
    """Device busy ms per call of ``fn(*args)``: the time during which
    any GPU event of a ``jax.profiler`` trace of ``n`` calls is running
    (the union of their intervals, so overlapping events and lines that
    repeat one kernel count once)."""
    import glob
    import tempfile

    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                jax.block_until_ready(fn(*args))
        (path,) = glob.glob(f"{d}/**/*.xplane.pb", recursive=True)
        spans = sorted(
            (ev.start_ns, ev.start_ns + ev.duration_ns)
            for plane in ProfileData.from_file(path).planes
            if "/device:GPU" in plane.name
            for line in plane.lines
            for ev in line.events
        )
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / n / 1e6


def make_stream(frames, cfg, backend: str):
    """``run()`` pushes ``frames`` through the streaming flow step (the
    pyramid of each frame built once and carried) and returns per-frame
    host seconds to ``block_until_ready``; ``run(sync_each=False)``
    waits once, at the end, and returns the mean. Compiled before it
    returns."""
    import jax

    from tpuflow.flow.pyramidal import lucas_kanade_pyramidal_step
    from tpuflow.kernels import jnp_ref

    step = jax.jit(
        functools.partial(lucas_kanade_pyramidal_step, cfg=cfg, backend=backend)
    )
    pyr0 = jax.jit(
        lambda f: jnp_ref.build_gaussian_pyramid(f, cfg.levels, cfg.scale_factor)
    )(frames[0])
    jax.block_until_ready(step(pyr0, frames[1]))

    def run(sync_each: bool = True) -> list[float]:
        times = []
        pyr = pyr0
        t_all = time.perf_counter()
        for f in frames[1:]:
            t0 = time.perf_counter()
            u, v, pyr = step(pyr, f)
            if sync_each:
                jax.block_until_ready((u, v))
            times.append(time.perf_counter() - t0)
        if not sync_each:
            # Dispatch runs ahead of the device: only the whole stream
            # has a meaningful host time.
            jax.block_until_ready((u, v))
            times = [(time.perf_counter() - t_all) / (len(frames) - 1)]
        return times

    return run


def profile_pipeline(
    height: int = 1080, width: int = 1920, config: str = "production",
    n_frames: int = 16, seed: int = 0,
) -> list[dict]:
    """Time each stage at (height, width); returns report rows."""
    import jax
    import jax.numpy as jnp

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.eval.chip import shifted, textured_frame
    from tpuflow.flow.backend import BACKENDS, is_clamped, require_gpu
    from tpuflow.kernels import jnp_ref, pallas_lk

    require_gpu()
    cfg = PYRAMID_CONFIGS[config]
    h, w = height, width
    base = textured_frame(h, w, seed)
    prev = jnp.asarray(base)
    curr = jnp.asarray(shifted(base, 0.0, 1.7))
    rng = np.random.default_rng(seed + 1)
    u0 = jnp.asarray(rng.uniform(-3, 3, (h, w)), jnp.float32)
    conv = jnp.asarray(False)
    band = (float(cfg.max_disp), float(cfg.max_disp_v_effective))

    def xla_refine(p, c, u, v, converged):
        # The "xla" backend's loop body minus the warp: the same chain
        # the kernel fuses (clip, LK, latch, accumulate, |d| sums).
        du, dv = jnp_ref.lucas_kanade_from_gradients(
            *jnp_ref.compute_gradients(p, c), window_size=cfg.window_size
        )
        uc, vc = jnp_ref.clamp_flow(u, v, *band)
        return (jnp.where(converged, uc, uc + du),
                jnp.where(converged, vc, vc + dv),
                jnp.sum(jnp.abs(du)), jnp.sum(jnp.abs(dv)))

    def clamped_warp(img, u, v):
        return jnp_ref.warp_image(img, *jnp_ref.clamp_flow(u, v, *band))

    kernel = jax.jit(functools.partial(
        pallas_lk.refine, height=h, width=w, window_size=cfg.window_size,
        max_disp=band[0], max_disp_v=band[1],
    ))
    stages = [
        ("warp, clamped (XLA gather)", jax.jit(clamped_warp), (curr, u0, u0)),
        ("LK refine (XLA)", jax.jit(xla_refine), (prev, curr, u0, u0, conv)),
        ("LK refine (Pallas kernel)", kernel,
         (pallas_lk.pad_frame(prev, cfg.window_size),
          pallas_lk.pad_frame(curr, cfg.window_size),
          pallas_lk.pad_flow(u0), pallas_lk.pad_flow(u0), conv)),
        ("pyramid build (1 frame)", jax.jit(functools.partial(
            jnp_ref.build_gaussian_pyramid, num_levels=cfg.levels,
            scale_factor=cfg.scale_factor,
        )), (curr,)),
        ("flow upsample (2x)", jax.jit(functools.partial(
            jnp_ref.upsample_flow, target_shape=(h, w),
        )), (u0[: h // 2, : w // 2], u0[: h // 2, : w // 2])),
    ]
    rows = [
        {"stage": name, "host_ms": host_ms(fn, *args),
         "device_ms": device_ms(fn, *args)}
        for name, fn, args in stages
    ]

    # The warp at every level's shape: one call per refinement iteration.
    for level in jnp_ref.build_gaussian_pyramid(curr, cfg.levels, cfg.scale_factor):
        lh, lw = level.shape
        ul = jnp.asarray(rng.uniform(-3, 3, (lh, lw)), jnp.float32)
        rows.append({"stage": f"warp level {lh}x{lw} (XLA gather)",
                     "device_ms": device_ms(jax.jit(clamped_warp), level, ul, ul)})

    streams = {
        "benign": [jnp.asarray(shifted(base, 0.0, 1.7 * k)) for k in range(n_frames)],
        "adversarial": [
            jnp.asarray(rng.uniform(0, 255, (h, w)), jnp.float32)
            for _ in range(n_frames)
        ],
    }
    fast = [b for b in BACKENDS if is_clamped(b)]
    for kind, frames in streams.items():
        runs = {b: make_stream(frames, cfg, b) for b in fast}
        for b in (*fast, *reversed(fast)):
            per_frame = np.asarray(runs[b]()) * 1e3
            busy = device_ms(runs[b], n=1) / (len(frames) - 1)
            rows.append({
                "stage": f"stream per frame, {kind} ({b})",
                "host_ms": float(np.median(per_frame)),
                "host_ms_p10": float(np.quantile(per_frame, 0.1)),
                "host_ms_p90": float(np.quantile(per_frame, 0.9)),
                "pipelined_host_ms": runs[b](sync_each=False)[0] * 1e3,
                "device_ms": busy,
            })
    return rows


def main() -> None:
    import argparse
    import json

    from tpuflow.compile_cache import setup_compile_cache

    setup_compile_cache()
    from tpuflow.eval.chip import device_record

    parser = argparse.ArgumentParser(description="Profile the flow pipeline")
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--config", type=str, default="production")
    parser.add_argument("--json", type=str, default=None, metavar="PATH",
                        help="also write the rows to PATH")
    args = parser.parse_args()
    rows = profile_pipeline(args.height, args.width, args.config)
    dev = device_record()
    out = [{**r, "height": args.height, "width": args.width,
            "config": args.config, "device": dev} for r in rows]
    for r in out:
        print(json.dumps(r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
