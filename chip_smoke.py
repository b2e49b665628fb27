#!/usr/bin/env python3
"""Smoke test of the flow and VO serving path on one GPU.

    python chip_smoke.py [--seed N]      # phases 0-4 on the first GPU
    python chip_smoke.py --four          # phase 5 only, on four GPUs
    python chip_smoke.py --rehearse      # phases 1-4 at tiny sizes on
                                         # the CPU, Pallas interpreted

Runs as one process; imports only numpy, scipy, JAX and this repo.
Frames are made from ``--seed``: a Gaussian-filtered noise texture with
integer gray levels, shifted sub-pixel with ``scipy.ndimage.shift``, so
the true flow is known. Each phase prints one JSON line; a failed phase
prints its error and the script exits 1 without a result line.

0. Device: platform, kind, count, JAX version, XLA_FLAGS, compile-cache
   directory and the card's name and power limit. Fails unless the
   platform is ``gpu``.
1. Kernel check: the fused Pallas LK refine kernel compiled at every
   level width of the 1080p and 4K pyramids, compared once with the
   jnp composition on the card at HIGHEST matmul precision, with
   ``compiled.memory_analysis()``.
2. 1080p flow stream through ``lucas_kanade_pyramidal_step`` with the
   ``production`` config and the resolved fast backend, plus one pair
   with vertical motion (the ladder's wide band), compared with the
   same fast-path semantics computed by XLA on the CPU in this process;
   EPE against the known shift, per-level iteration counts, per-frame
   host time ("smoke timing": not a benchmark) and peak device memory.
3. The same at 4K.
4. 1080p VO: ``OdometrySession`` with ``production`` flow and the
   forward-backward check on frames rendered by the homography renderer
   of ``tpuflow.eval.vo_verifier``; ATE/RPE within that module's
   absolute gate bounds.
5. ``--four`` only: tiled pyramidal flow at 4K on a (1, 2, 2) mesh and
   data-parallel (4, 1, 1) batches, each against single-device results;
   the distributed BA step of ``__graft_entry__``; a mesh-tiled
   ``OdometrySession`` for 3 frames.

The last line is ``{"ok": true, "device": {...}}`` only after a full run
on GPUs; a rehearsal ends with a line that says it was one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tpuflow.compile_cache import setup_compile_cache  # noqa: E402

import numpy as np  # noqa: E402

# Tolerances, each with its reason.
# Kernel vs jnp composition on the card: the same float32 operations,
# with the window sums added rows-first instead of columns-first.
KERNEL_MAX_PX = 1e-3
KERNEL_SUM_REL = 1e-5
# GPU stream vs the same semantics on the CPU: XLA's GPU and CPU
# backends contract and reduce in different orders, and the early exit
# or the band choice can flip on last-bit differences; the interior mean
# stays far below what any real fault produces.
STREAM_MEAN_PX = 1e-3
# EPE against the known shift: three iterations per level leave about
# 0.16 px on the horizontal and 0.26 px on the vertical pair (measured
# on the CPU from 270x480 to 1080p); a broken warp, clamp or solve gives
# a pixel or more.
EPE_MAX_PX = 0.5
# Tiled and data-parallel vs single device: the distributed pyramid
# build's banded operators round differently from the single-device
# ones. Every other step samples and sums as the single device does
# (bit-exact on one card with a (1, 1, 1) mesh).
TILED_MEAN_PX = 1e-3
TILED_MAX_PX = 1e-3

FULL = {
    "levels": [(2160, 3840), (1080, 1920), (540, 960), (270, 480)],
    "flow": [("1080p", 1080, 1920, 9), ("4K", 2160, 3840, 3)],
    "vo": (1080, 1920, 16, 32),
    "four": (2160, 3840, 1080, 1920),
}
REHEARSE = {
    "levels": [(80, 128), (40, 64), (20, 32)],
    "flow": [("1080p", 120, 192, 4), ("4K", 144, 256, 3)],
    "vo": (160, 240, 8, 12),
    "four": (96, 160, 64, 96),
}


class PhaseError(RuntimeError):
    pass


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def interior(a: np.ndarray, margin: int) -> np.ndarray:
    h, w = a.shape[-2:]
    m_y = min(margin, h // 4)
    m_x = min(margin, w // 4)
    return a[..., m_y : h - m_y, m_x : w - m_x]


def memory_record(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    return {k: int(getattr(ma, k)) for k in dir(ma) if k.endswith("_in_bytes")}


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_device(cache_dir: str, rehearse: bool, n_expected: int) -> dict:
    import jax

    from tpuflow.eval.chip import device_record

    rec = {**device_record(), "cache_dir": cache_dir}
    want = "cpu" if rehearse else "gpu"
    check(rec["platform"] == want,
          f"platform is {rec['platform']!r}, this run needs {want!r}")
    check(len(jax.devices()) >= n_expected,
          f"{len(jax.devices())} devices, this run needs {n_expected}")
    return rec


def phase_kernel(levels, seed: int) -> dict:
    import functools

    import jax
    import jax.numpy as jnp

    from tpuflow.eval.chip import shifted, textured_frame
    from tpuflow.kernels import jnp_ref, pallas_lk

    max_disp, max_disp_v, window = 8.0, 8.0, 5
    rows = []
    for h, w in levels:
        rng = np.random.default_rng(seed + h)
        prev_np = textured_frame(h, w, seed + h)
        prev = jnp.asarray(prev_np)
        warped = jnp.asarray(shifted(prev_np, 0.4, 0.7))
        u = jnp.asarray(rng.uniform(-10, 10, (h, w)), jnp.float32)
        v = jnp.asarray(rng.uniform(-10, 10, (h, w)), jnp.float32)
        conv = jnp.asarray(False)
        with jax.default_matmul_precision("highest"):
            du, dv = jnp_ref.lucas_kanade_from_gradients(
                *jnp_ref.compute_gradients(prev, warped), window_size=window
            )
            ref_u = np.asarray(jnp.clip(u, -max_disp, max_disp) + du)
            ref_v = np.asarray(jnp.clip(v, -max_disp_v, max_disp_v) + dv)
            ref_s = (float(jnp.sum(jnp.abs(du))), float(jnp.sum(jnp.abs(dv))))
        fn = jax.jit(functools.partial(
            pallas_lk.refine, height=h, width=w, window_size=window,
            max_disp=max_disp, max_disp_v=max_disp_v,
        ))
        args = (pallas_lk.pad_frame(prev, window),
                pallas_lk.pad_frame(warped, window),
                pallas_lk.pad_flow(u), pallas_lk.pad_flow(v), conv)
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        ku, kv, su, sv = compiled(*args)
        d_u = np.abs(np.asarray(ku)[:h, :w] - ref_u)
        d_v = np.abs(np.asarray(kv)[:h, :w] - ref_v)
        sum_rel = max(abs(float(su) - ref_s[0]) / max(ref_s[0], 1e-9),
                      abs(float(sv) - ref_s[1]) / max(ref_s[1], 1e-9))
        row = {
            "h": h, "w": w, "compile_s": compile_s,
            "max_du": float(d_u.max()), "mean_du": float(d_u.mean()),
            "max_dv": float(d_v.max()), "mean_dv": float(d_v.mean()),
            "sum_rel": sum_rel, "memory": memory_record(compiled),
        }
        rows.append(row)
        check(row["max_du"] <= KERNEL_MAX_PX and row["max_dv"] <= KERNEL_MAX_PX,
              f"kernel vs jnp at {h}x{w}: max |d| {row['max_du']}, "
              f"{row['max_dv']} > {KERNEL_MAX_PX}")
        check(sum_rel <= KERNEL_SUM_REL,
              f"kernel |du| sums at {h}x{w}: rel {sum_rel} > {KERNEL_SUM_REL}")
    return {"levels": rows, "tolerance": {"max_px": KERNEL_MAX_PX,
                                          "sum_rel": KERNEL_SUM_REL}}


def phase_flow(label: str, h: int, w: int, n_frames: int, seed: int,
               backend: str) -> dict:
    import functools

    import jax

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.eval.chip import shifted, textured_frame
    from tpuflow.flow import lucas_kanade_pyramidal_step
    from tpuflow.kernels import jnp_ref

    cfg = PYRAMID_CONFIGS["production"]
    margin = 2 * (cfg.max_disp + cfg.window_size)
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    base = textured_frame(h, w, seed)
    step_dx = 1.7
    # The benign stream, then one pair with real vertical motion.
    pairs = [(shifted(base, 0.0, step_dx * k), shifted(base, 0.0, step_dx * (k + 1)),
              (0.0, step_dx)) for k in range(n_frames - 1)]
    pairs.append((base, shifted(base, 2.6, 0.8), (2.6, 0.8)))

    def make_step(b):
        return jax.jit(functools.partial(
            lucas_kanade_pyramidal_step, cfg=cfg, backend=b,
            return_iterations=True,
        ))

    pyramid = jax.jit(
        lambda f: jnp_ref.build_gaussian_pyramid(f, cfg.levels, cfg.scale_factor)
    )

    def run(device, b):
        step = make_step(b)
        outs, times = [], []
        for i, (f0, f1, _) in enumerate(pairs):
            # The stream carries each frame's pyramid; the vertical pair
            # starts a new one.
            if i == 0 or i == len(pairs) - 1:
                pyr = pyramid(jax.device_put(f0, device))
            t0 = time.perf_counter()
            u, v, iters, pyr = step(pyr, jax.device_put(f1, device))
            jax.block_until_ready((u, v))
            times.append(time.perf_counter() - t0)
            outs.append((np.asarray(u), np.asarray(v), np.asarray(iters)))
        return outs, times

    outs, times = run(dev, backend)
    ref, _ = run(cpu, "xla")
    per_pair = []
    for (u, v, it), (ru, rv, rit), (_, _, (dy, dx)) in zip(outs, ref, pairs):
        check(bool(np.all(np.isfinite(u)) and np.all(np.isfinite(v))),
              f"{label}: non-finite flow")
        epe = float(np.mean(np.hypot(interior(u, margin) - dx,
                                     interior(v, margin) - dy)))
        per_pair.append({
            "motion": [dy, dx],
            "mean_du_vs_cpu": float(np.mean(np.abs(interior(u - ru, margin)))),
            "mean_dv_vs_cpu": float(np.mean(np.abs(interior(v - rv, margin)))),
            "max_du_vs_cpu": float(np.max(np.abs(interior(u - ru, margin)))),
            "epe": epe,
            "iterations": it.tolist(),
            "iterations_cpu": rit.tolist(),
        })
    for p in per_pair:
        check(p["mean_du_vs_cpu"] <= STREAM_MEAN_PX
              and p["mean_dv_vs_cpu"] <= STREAM_MEAN_PX,
              f"{label}: GPU vs CPU interior mean |d| {p['mean_du_vs_cpu']}, "
              f"{p['mean_dv_vs_cpu']} > {STREAM_MEAN_PX}")
        check(p["epe"] <= EPE_MAX_PX,
              f"{label}: EPE {p['epe']} > {EPE_MAX_PX} for motion {p['motion']}")
    stream_ms = [t * 1e3 for t in times[1:-1]]
    return {
        "size": [h, w], "backend": backend, "config": "production",
        "pairs": per_pair,
        "tolerance": {"mean_px_vs_cpu": STREAM_MEAN_PX, "epe_px": EPE_MAX_PX},
        "smoke_timing_ms": {"first_call": times[0] * 1e3,
                            "stream_median": float(np.median(stream_ms)),
                            "stream": stream_ms},
        "peak_bytes_in_use": peak_bytes(dev),
    }


def render_vo_frames(h: int, w: int, n: int, seed: int):
    from tpuflow.eval import vo_verifier
    from tpuflow.eval.chip import textured_frame

    fx = vo_verifier.FX * w / vo_verifier.WIDTH
    k = (fx, fx, w / 2.0, h / 2.0)
    depth = vo_verifier.PLANE_DEPTH
    # About 2.5 px/frame sideways and 0.6 px/frame down in the image.
    step = np.array([2.5, 0.6, 0.0]) * depth / fx
    rs, ts = [], []
    for i in range(n):
        r, t = vo_verifier._pose_from_center(np.eye(3), step * i)
        rs.append(r)
        ts.append(t)
    gt_r, gt_t = np.stack(rs), np.stack(ts)
    frames = vo_verifier.render_sequence(
        gt_r, gt_t, width=w, height=h, depth=depth,
        base=textured_frame(h, w, seed), k=k,
    )
    return k, gt_r, gt_t, frames


def phase_vo(h: int, w: int, n: int, grid_step: int, seed: int,
             backend: str) -> dict:
    import jax

    from tpuflow.eval import vo_verifier
    from tpuflow.eval.vo_metrics import trajectory_metrics
    from tpuflow.vo.pipeline import OdometrySession

    k, gt_r, gt_t, frames = render_vo_frames(h, w, n, seed)
    sess = OdometrySession(
        k, grid_step=grid_step, init_depth=vo_verifier.PLANE_DEPTH,
        backend=backend, fb_check_threshold=1.0,
        pyramid_config="production",
    )
    t0 = time.perf_counter()
    sess.start(frames[0])
    sess.process_frames(np.stack(frames[1:]))
    res = sess.solve(ba_iterations=8)
    wall = time.perf_counter() - t0
    kf = res.keyframe_indices
    metrics = trajectory_metrics(
        res.poses_r, res.poses_t, gt_r[kf], gt_t[kf],
        with_scale=not res.metric_poses,
    )
    record = {"sequence": "chip_smoke_strafe", "metrics": metrics,
              "track_count": int(res.track_count)}
    ok = vo_verifier.check_absolute_bounds([record], verbose=False)
    out = {
        "size": [h, w], "frames": n, "backend": backend,
        "config": "production", "fb_check_threshold": 1.0,
        "metrics": {k2: float(v) for k2, v in metrics.items()},
        "track_count": record["track_count"],
        "bounds": {"ate_rmse": vo_verifier.ABS_ATE_DEFAULT,
                   "rpe_rot_deg": vo_verifier.ABS_RPE_ROT_DEG,
                   "min_tracks": vo_verifier.MIN_TRACK_COUNT},
        "smoke_timing_s": {"start_process_solve": wall},
        "peak_bytes_in_use": peak_bytes(jax.devices()[0]),
    }
    check(ok, f"VO outside the absolute bounds: {out['metrics']}, "
              f"tracks {out['track_count']}")
    return out


def differences(u, v, ref_u, ref_v, margin: int) -> dict:
    """Interior mean and max |u - ref_u|, |v - ref_v|."""
    du = np.abs(interior(u - ref_u, margin))
    dv = np.abs(interior(v - ref_v, margin))
    return {"mean_du": float(du.mean()), "mean_dv": float(dv.mean()),
            "max_du": float(du.max()), "max_dv": float(dv.max())}


def phase_four(sizes, seed: int, backend: str) -> dict:
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.eval.chip import shifted, textured_frame
    from tpuflow.flow import lucas_kanade_pyramidal
    from tpuflow.sharding import make_flow_mesh
    from tpuflow.sharding.tiled_pyramidal import tiled_lucas_kanade_pyramidal
    from tpuflow.vo.pipeline import OdometrySession

    devs = jax.devices()[:4]
    # The tiled path runs the static band (no ladder): compare the
    # single-device fast path under the same static config.
    cfg = PYRAMID_CONFIGS["default"]
    margin = 2 * (cfg.max_disp + cfg.window_size)
    single = jax.jit(lambda p, c: lucas_kanade_pyramidal(
        p, c, config=cfg, backend=backend))
    out = {}

    th, tw, dh, dw = sizes
    base = textured_frame(th, tw, seed)
    prev, curr = base, shifted(base, 0.6, 1.7)
    su, sv = (np.asarray(x) for x in single(jnp.asarray(prev), jnp.asarray(curr)))
    t0 = time.perf_counter()
    tu, tv = tiled_lucas_kanade_pyramidal(
        prev[None], curr[None], make_flow_mesh(1, 2, 2, devices=devs),
        config=cfg, backend=backend,
    )
    tu, tv = np.asarray(tu)[0], np.asarray(tv)[0]
    out["tiled_1x2x2"] = {
        "size": [th, tw], "first_call_s": time.perf_counter() - t0,
        **differences(tu, tv, su, sv, margin),
    }

    frames = [textured_frame(dh, dw, seed + i) for i in range(4)]
    prevs = np.stack(frames)
    currs = np.stack([shifted(f, 0.3 * i, 1.2) for i, f in enumerate(frames)])
    bu, bv = tiled_lucas_kanade_pyramidal(
        prevs, currs, make_flow_mesh(4, 1, 1, devices=devs),
        config=cfg, backend=backend,
    )
    bu, bv = np.asarray(bu), np.asarray(bv)
    diffs = []
    for i in range(4):
        pu, pv = (np.asarray(x) for x in single(
            jnp.asarray(prevs[i]), jnp.asarray(currs[i])))
        diffs.append(differences(bu[i], bv[i], pu, pv, margin))
    out["data_parallel_4x1x1"] = {"size": [dh, dw], "per_frame": diffs}

    __graft_entry__.distributed_ba_step(devs, np.random.default_rng(seed))
    out["distributed_ba_step"] = "finite"

    k, _, _, vo_frames = render_vo_frames(dh, dw, 3, seed)
    sess = OdometrySession(
        k, grid_step=32, backend=backend,
        mesh=make_flow_mesh(1, 2, 2, devices=devs),
    )
    for f in vo_frames:
        sess.process_frame(f)
    res = sess.solve(ba_iterations=3)
    out["vo_mesh_1x2x2"] = {"frames": 3, "track_count": int(res.track_count)}
    out["tolerance"] = {"mean_px": TILED_MEAN_PX, "max_px": TILED_MAX_PX}

    for name, d in [("tiled vs single", out["tiled_1x2x2"])] + [
            (f"data-parallel frame {i} vs single", d) for i, d in enumerate(diffs)]:
        check(max(d["mean_du"], d["mean_dv"]) <= TILED_MEAN_PX
              and max(d["max_du"], d["max_dv"]) <= TILED_MAX_PX,
              f"{name}: {d} beyond mean {TILED_MEAN_PX} / max {TILED_MAX_PX}")
    check(bool(np.all(np.isfinite(res.poses_t))), "mesh VO: non-finite poses")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run only the four-device phase")
    parser.add_argument("--rehearse", action="store_true",
                        help="tiny sizes on the CPU, Pallas interpreted")
    args = parser.parse_args(argv)
    cache_dir = setup_compile_cache()

    import jax

    from tpuflow.flow.backend import GPU_FAST_BACKEND, fast_backend

    sizes = REHEARSE if args.rehearse else FULL
    n_dev = 4 if args.four else 1

    def run(i: int, name: str, fn) -> bool:
        t0 = time.perf_counter()
        try:
            result = fn()
        except Exception as exc:  # a failed phase ends the run
            traceback.print_exc()
            emit({"phase": i, "name": name, "ok": False,
                  "error": f"{type(exc).__name__}: {exc}"})
            return False
        emit({"phase": i, "name": name, "ok": True,
              "seconds": time.perf_counter() - t0, **result})
        return True

    if not run(0, "device", lambda: phase_device(cache_dir, args.rehearse, n_dev)):
        return 1
    # The rehearsal runs the GPU's backend, interpreted, on the CPU.
    backend = GPU_FAST_BACKEND if args.rehearse else fast_backend()

    if args.four:
        phases = [("four_devices", lambda: phase_four(
            sizes["four"], args.seed, backend))]
    else:
        phases = []
        if backend == "pallas":
            phases.append(("kernel_check", lambda: phase_kernel(
                sizes["levels"], args.seed)))
        for label, h, w, n in sizes["flow"]:
            phases.append((f"flow_{label}", lambda label=label, h=h, w=w, n=n:
                           phase_flow(label, h, w, n, args.seed, backend)))
        h, w, n, grid = sizes["vo"]
        phases.append(("vo_1080p", lambda: phase_vo(
            h, w, n, grid, args.seed, backend)))

    with contextlib.ExitStack() as stack:
        if args.rehearse:
            from tpuflow.kernels import pallas_lk

            stack.enter_context(pallas_lk.interpret_mode())
        for i, (name, fn) in enumerate(phases, start=1):
            if not run(i, name, fn):
                return 1

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if args.rehearse:
        emit({"rehearsal": "passed", "device": device})
        return 0
    from tpuflow.eval.chip import nvidia_smi

    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    if "--rehearse" in sys.argv:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if "--four" in sys.argv and "device_count" not in os.environ.get("XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )
    sys.exit(main())
