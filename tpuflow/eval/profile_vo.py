"""Per-stage latency decomposition of the composed VO serving step.

The device_loop analog of ``eval.profile`` for the flow pipeline, and
of the reference TB's cycle-accounted pipeline latency model
(tb/tb_optical_flow_top.sv:118-129). Each stage is timed alone on the
host clock around ``block_until_ready`` (``eval.profile.host_ms``).
Fails without a GPU. Stages:

- ``flow step (build+solve)``: one streaming flow step on carried
  pyramids (``lucas_kanade_pyramidal_step``) — builds the NEW frame's
  pyramid and refines; the flow work the VO step actually does.
- ``pyramid build (1 frame)``: the build alone.
- ``seed_grid (Shi-Tomasi)``: the full-frame corner response +
  grid-cell argmax the keyframe reseed runs (every frame at
  keyframe_stride=1).
- ``advance (track gathers)``: dense-flow sampling + border cull of
  the track table.
- ``full VO step``: the whole ``FrontEnd._step`` (flow + advance +
  loss stats + reseed cond), the serving loop body.

Every stage body returns what its whole computation feeds, so nothing
is dead-code eliminated.
"""

from __future__ import annotations

import numpy as np

from tpuflow.eval.profile import host_ms


def profile_vo(
    height: int = 1080,
    width: int = 1920,
    config: str = "production",
    grid_step: int = 16,
    fb_check: float | None = None,
) -> list[dict]:
    import jax
    import jax.numpy as jnp

    from tpuflow.core.config import PYRAMID_CONFIGS
    from tpuflow.flow.pyramidal import lucas_kanade_pyramidal_step
    from tpuflow.kernels import jnp_ref
    from tpuflow.vo import tracking
    from tpuflow.vo.device_loop import get_front_end

    from tpuflow.eval.chip import shifted, textured_frame
    from tpuflow.flow.backend import fast_backend

    cfg = PYRAMID_CONFIGS[config]
    backend = fast_backend()
    h, w = height, width

    f0 = textured_frame(h, w, 0)
    frame0 = jnp.asarray(f0)
    frame1 = jnp.asarray(shifted(f0, 0.0, 1.7))
    pyr0 = tuple(
        jnp_ref.build_gaussian_pyramid(frame0, cfg.levels, cfg.scale_factor)
    )
    rng = np.random.default_rng(3)
    u0 = jnp.asarray(rng.uniform(-2, 2, (h, w)), jnp.float32)

    fe = get_front_end(
        grid_step=grid_step, keyframe_stride=1,
        fb_check_threshold=fb_check, backend=backend, config=cfg,
    )
    state0, _ = fe.init(frame0)
    jax.block_until_ready(state0.xy)
    tracks0 = tracking.Tracks(state0.xy, state0.start_xy, state0.age,
                              state0.alive)
    margin = fe.margin_for(h, w)

    def flow_step(x):
        u, v, _pyr = lucas_kanade_pyramidal_step(pyr0, x, cfg, backend=backend)
        return u, v

    def build(x):
        return jnp_ref.build_gaussian_pyramid(x, cfg.levels, cfg.scale_factor)

    def seed(x):
        t = tracking.seed_grid(x, grid_step=grid_step,
                               margin=fe.margin_for(h, w, for_cull=False))
        return t.xy, t.alive

    def advance(x):
        t = tracking.advance(tracks0, u0, u0 + x * 1e-12, margin=margin)
        return t.xy, t.age

    def full_step(x):
        return fe._step(state0, x)

    stages = [
        ("flow step (build+solve)", flow_step),
        ("pyramid build (1 frame)", build),
        ("seed_grid (Shi-Tomasi)", seed),
        ("advance (track gathers)", advance),
        ("full VO step", full_step),
    ]
    rows = []
    for name, fn in stages:
        rows.append({"stage": name, "ms": host_ms(jax.jit(fn), frame1)})
    # Accounting row: the gap the component stages don't explain.
    comp = {r["stage"]: r["ms"] for r in rows}
    explained = (
        comp["flow step (build+solve)"]
        + comp["seed_grid (Shi-Tomasi)"]
        + comp["advance (track gathers)"]
    )
    rows.append({
        "stage": "unexplained (full - flow - seed - advance)",
        "ms": comp["full VO step"] - explained,
    })
    return rows


def main() -> None:
    import argparse
    import json

    from tpuflow.compile_cache import setup_compile_cache

    setup_compile_cache()
    from tpuflow.eval.chip import device_record

    parser = argparse.ArgumentParser(
        description="Per-stage profile of the VO serving step"
    )
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--config", type=str, default="production")
    parser.add_argument("--grid-step", type=int, default=16)
    parser.add_argument("--fb-check", type=float, default=None)
    args = parser.parse_args()

    rows = profile_vo(args.height, args.width, args.config,
                      args.grid_step, args.fb_check)
    dev = device_record()
    for r in rows:
        print(json.dumps({**r, "height": args.height, "width": args.width,
                          "config": args.config, "fb_check": args.fb_check,
                          "device": dev}))


if __name__ == "__main__":
    main()
