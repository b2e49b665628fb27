"""Frame-pair flow CLI — the reference's single-scale / pyramidal driver
scripts as one tool.

Reference parity: python/lucas_kanade_reference.py:106-208 (load
frame_00/01.bin, run single-scale, print statistics over the textured
test region y[105:135] x[55:85], export ``flow_field_python.txt`` and a
quiver plot) and the pyramidal wrapper main() in
python/lucas_kanade_pyramidal.py. One CLI covers both modes plus the
fast path:

    python -m tpuflow.flow FRAME_DIR [--pyramidal] [--backend pallas]
        [--width W --height H] [--region x0 x1 y0 y1]
        [--export flow.txt] [--plot flow.png] [--compare other.txt]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def region_stats(u: np.ndarray, v: np.ndarray, region) -> dict:
    """Mean/std statistics over the test region (reference
    lucas_kanade_reference.py prints the same block for x[55:85]
    y[105:135])."""
    x0, x1, y0, y1 = region
    ru = u[y0:y1, x0:x1]
    rv = v[y0:y1, x0:x1]
    mag = np.sqrt(ru**2 + rv**2)
    return {
        "mean_u": float(ru.mean()),
        "mean_v": float(rv.mean()),
        "std_u": float(ru.std()),
        "std_v": float(rv.std()),
        "mean_magnitude": float(mag.mean()),
        "nonzero_fraction": float((mag > 1e-6).mean()),
    }


def _run_sequence(d, args) -> None:
    """Stream a frame sequence through the flow engine (serving path):
    prefetching FrameStream -> jitted pyramidal/single-scale flow, one
    program reused across all pairs."""
    import time

    import jax
    import jax.numpy as jnp

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow import lucas_kanade_single_scale
    from tpuflow.io.stream import FrameStream, device_pairs

    if d.is_file():
        # Video container input (host-side cv2 decode at native
        # resolution; tpuflow.io.video).
        from tpuflow.io.video import VideoFrameStream

        stream = VideoFrameStream(str(d))
        if stream.frame_count is not None and stream.frame_count < 2:
            print(f"error: {d} has fewer than 2 frames", file=sys.stderr)
            sys.exit(1)
        n_frames = stream.frame_count or "?"
        src = f"video {d.name}"
    else:
        paths = sorted(d.glob(args.glob))
        if len(paths) < 2:
            print(f"error: need >=2 frames matching {args.glob} in {d}",
                  file=sys.stderr)
            sys.exit(1)
        stream = FrameStream(paths, width=args.width, height=args.height)
        n_frames = len(paths)
        src = f"{len(paths)} files"

    pyr_carry = None
    if args.pyramidal:
        # Streaming form: carry each frame's pyramid to the next pair
        # (bit-identical to the per-pair call; builds one pyramid per
        # frame instead of two).
        from tpuflow.flow import lucas_kanade_pyramidal_step
        from tpuflow.kernels import jnp_ref

        cfg = PYRAMID_CONFIGS[args.pyramid_config]
        step = jax.jit(lambda pyr, c: lucas_kanade_pyramidal_step(
            pyr, c, cfg, backend=args.backend))
        mode = f"pyramidal[{args.pyramid_config}]"
    else:
        fn = jax.jit(lambda p, c: lucas_kanade_single_scale(
            p, c, args.window_size))
        mode = "single-scale"

    n = 0
    mags = []  # device scalars — no per-pair host sync, dispatches pipeline
    t0 = None
    # device_pairs: each frame is device_put exactly once, two H2D
    # transfers in flight ahead of the compute consuming them (the
    # host-side double buffer; tpuflow.io.stream.prefetch_to_device).
    for prev, curr in device_pairs(stream, lookahead=2):
        if args.pyramidal:
            if pyr_carry is None:
                pyr_carry = jnp_ref.build_gaussian_pyramid(
                    prev, cfg.levels, cfg.scale_factor
                )
            u, v, pyr_carry = step(pyr_carry, curr)
        else:
            u, v = fn(prev, curr)
        if t0 is None:  # exclude the first pair's compile
            u.block_until_ready()
            t0 = time.perf_counter()
        mags.append(jnp.sqrt(u * u + v * v).mean())
        n += 1
        if args.export:
            from tpuflow.io import frames as fio

            fio.save_flow_text(
                f"{args.export}.{n:04d}", np.asarray(u), np.asarray(v),
                header=f"pair {n} ({src})",
            )
    if n == 0:
        # E.g. a 1-frame video, or one whose container hides the count.
        print(f"error: no frame pairs decoded from {d}", file=sys.stderr)
        sys.exit(1)
    mean_mag = float(jnp.stack(mags).sum()) / n  # single end-of-stream sync
    dt = time.perf_counter() - t0
    done = max(n - 1, 1)  # pairs timed after the compile pair
    print(f"mode: {mode}  backend: {args.backend}  "
          f"frames: {n_frames} ({src})  pairs: {n}")
    print(f"throughput: {done / dt:.1f} pairs/s "
          f"({dt / done * 1e3:.2f} ms/pair, first pair excluded)")
    print(f"mean flow magnitude: {mean_mag:.3f} px")


def main() -> None:
    parser = argparse.ArgumentParser(
        prog="python -m tpuflow.flow",
        description="Dense Lucas-Kanade flow on a frame_00/01 pair",
    )
    parser.add_argument(
        "frame_dir",
        help="directory containing frame_00.bin and frame_01.bin "
        "(or .mem with --mem), or a video file (mp4/avi/... — "
        "implies --sequence, decoded at native resolution)",
    )
    parser.add_argument("--mem", action="store_true",
                        help="load $readmemh .mem frames instead of .bin")
    parser.add_argument("--sequence", action="store_true",
                        help="stream ALL .bin frames in frame_dir (sorted) "
                        "through the flow engine via the prefetching "
                        "FrameStream and report throughput")
    parser.add_argument("--glob", type=str, default="frame_*.bin",
                        help="frame filename pattern for --sequence")
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--pyramidal", action="store_true",
                        help="3-level coarse-to-fine instead of single-scale")
    parser.add_argument("--pyramid-config", type=str, default="default",
                        help="named config: default/shallow/deep/large_window")
    parser.add_argument("--window-size", type=int, default=5)
    parser.add_argument("--backend", type=str, default="jnp",
                        choices=["jnp", "xla", "pallas", "rtl"],
                        help="jnp = golden-parity float32; xla / pallas = "
                        "the saturating fast path (pallas: fused GPU LK "
                        "kernel); rtl = S8.7 integer datapath "
                        "(single-scale only — the reference hardware's "
                        "numerics, the analog of run_sim.sh's "
                        "flow_field_rtl.txt output)")
    parser.add_argument("--region", type=int, nargs=4,
                        metavar=("X0", "X1", "Y0", "Y1"),
                        default=[55, 85, 105, 135],
                        help="stats region (reference test region default)")
    parser.add_argument("--export", type=str, default=None,
                        help="write x-y-u-v flow text dump here")
    parser.add_argument("--plot", type=str, default=None,
                        help="write a quiver plot PNG here")
    parser.add_argument("--per-level-plots", type=str, default=None,
                        metavar="DIR",
                        help="with --pyramidal: write per-pyramid-level "
                        "U/V/magnitude snapshots (reference "
                        "visualize_pyramid_level analog) into DIR")
    parser.add_argument("--compare", type=str, default=None,
                        help="x-y-u-v dump to diff against (e.g. the "
                        "reference RTL's flow_field_rtl.txt)")
    args = parser.parse_args()

    from pathlib import Path

    from tpuflow.io import frames as fio

    d = Path(args.frame_dir)
    if args.backend == "rtl" and (args.pyramidal or args.sequence
                                  or d.is_file()):
        print("error: --backend rtl is single-scale frame-pair only "
              "(the reference RTL's integer datapath; its pyramidal FSM "
              "runs different per-level semantics — see PARITY.md N15; "
              "video input implies --sequence)",
              file=sys.stderr)
        sys.exit(2)

    if args.sequence or d.is_file():
        # A file path means a video container — always stream mode.
        _run_sequence(d, args)
        return
    ext = "mem" if args.mem else "bin"
    f0p, f1p = d / f"frame_00.{ext}", d / f"frame_01.{ext}"
    for p in (f0p, f1p):
        if not p.exists():
            print(f"error: {p} not found", file=sys.stderr)
            sys.exit(1)
    load = fio.load_frame_mem if args.mem else fio.load_frame_bin
    f0 = load(f0p, args.width, args.height)
    f1 = load(f1p, args.width, args.height)

    import jax.numpy as jnp

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow import (
        lucas_kanade_pyramidal,
        lucas_kanade_single_scale,
    )

    levels = None
    if args.pyramidal:
        cfg = PYRAMID_CONFIGS[args.pyramid_config]
        if args.per_level_plots:
            u, v, levels = lucas_kanade_pyramidal(
                jnp.asarray(f0), jnp.asarray(f1),
                config=cfg, backend=args.backend, return_levels=True,
            )
        else:
            u, v = lucas_kanade_pyramidal(
                jnp.asarray(f0), jnp.asarray(f1),
                config=cfg, backend=args.backend,
            )
        mode = f"pyramidal[{args.pyramid_config}]"
    elif args.backend == "rtl":
        # The reference accelerator's S8.7 integer datapath (the RTL
        # sim's flow_field_rtl.txt producer, run_sim.sh:30-62 analog).
        from tpuflow.kernels import fixed_point

        u, v = fixed_point.lucas_kanade_s87(
            jnp.asarray(np.clip(f0, 0, 255).astype(np.uint8)),
            jnp.asarray(np.clip(f1, 0, 255).astype(np.uint8)),
            window_size=args.window_size,
        )
        mode = "single-scale[S8.7 RTL]"
    else:
        u, v = lucas_kanade_single_scale(
            jnp.asarray(f0), jnp.asarray(f1),
            window_size=args.window_size,
        )
        mode = "single-scale"
    u = np.asarray(u)
    v = np.asarray(v)

    x0, x1, y0, y1 = args.region
    stats = region_stats(u, v, args.region)
    print(f"mode: {mode}  backend: {args.backend}  "
          f"frame: {args.width}x{args.height}")
    print(f"test region x[{x0}:{x1}] y[{y0}:{y1}]:")
    for k, val in stats.items():
        print(f"  {k:18s} {val:10.4f}")

    if args.export:
        fio.save_flow_text(
            args.export, u, v,
            header=f"tpuflow {mode} backend={args.backend}",
        )
        print(f"flow field -> {args.export}")

    if args.compare:
        cu, cv = fio.load_flow_text(args.compare)
        if cu.shape != u.shape:
            print(f"error: compare dump shape {cu.shape} != {u.shape}",
                  file=sys.stderr)
            sys.exit(1)
        du = np.abs(u - cu)
        dv = np.abs(v - cv)
        print(f"vs {args.compare}: mae_u={du.mean():.4f} "
              f"mae_v={dv.mean():.4f} max_u={du.max():.4f} "
              f"max_v={dv.max():.4f}")

    if args.plot:
        from tpuflow.eval import visualize

        visualize.quiver_plot(u, v, f"tpuflow {mode}", args.plot)
        print(f"quiver plot -> {args.plot}")

    if args.per_level_plots and levels is not None:
        from tpuflow.eval import visualize

        visualize.save_pyramid_levels(levels, args.per_level_plots)
        print(f"per-level snapshots -> {args.per_level_plots}")


if __name__ == "__main__":
    main()
