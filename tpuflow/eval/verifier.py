"""Verification harness: run both LK modes over the 13-pattern suite,
classify against thresholds, and gate on baseline regression.

JAX re-creation of the reference verifier (reference:
python/optical_flow_verifier.py:211-919): same pattern categories and
Pass/Warning/Fail thresholds (verification_config.yaml:6-27), same
test-region semantics (whole frame minus 10 px border for translation;
central 80x80 crop for rotation/zoom/combined;
optical_flow_verifier.py:96-138), same mae_u/mae_v/epe 10% regression
gate against a committed baseline JSON in the reference's schema
(optical_flow_verifier.py:586-634), exiting nonzero for CI on
regression (optical_flow_verifier.py:906-915).

The flow computation itself runs through tpuflow's jitted device
pipeline instead of the reference's per-pixel Python loop.
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tpuflow.core.config import PYRAMID_CONFIGS, PyramidConfig
from tpuflow.eval.metrics import compute_all_metrics
from tpuflow.eval import patterns as patterns_mod
from tpuflow.flow.backend import BACKENDS, is_clamped

REFERENCE_BASELINE = Path(__file__).parent / "data" / "reference_baseline.json"

# Pass/Warning thresholds per category (reference:
# verification_config.yaml:6-27).
THRESHOLDS: Dict[str, Tuple[float, float]] = {
    "translation": (0.5, 2.0),
    "rotation": (1.0, 3.0),
    "zoom": (1.0, 3.0),
    "combined": (2.0, 5.0),
}

# Pattern -> category (reference: verification_config.yaml:29-49).
PATTERN_CATEGORIES: Dict[str, str] = {
    "translate_small": "translation",
    "translate_medium": "translation",
    "translate_large": "translation",
    "translate_extreme": "translation",
    "translate_vertical": "translation",
    "translate_diagonal": "translation",
    "no_motion": "translation",
    "rotate_small": "rotation",
    "rotate_medium": "rotation",
    "rotate_large": "rotation",
    "zoom_in": "zoom",
    "zoom_out": "zoom",
    "translate_rotate": "combined",
}

CENTER_CROP = 80  # reference: verification_config.yaml:107
BORDER = 10       # reference: optical_flow_verifier.py:135

DEFAULT_CONFIG = Path(__file__).parent / "verification_config.yaml"


def apply_config(path) -> dict:
    """Load a verifier YAML config and apply its overrides.

    Mirrors the reference's config mechanism (verification_config.yaml
    loaded at optical_flow_verifier.py:27-33): thresholds, pattern
    categories, test-region geometry, and named pyramid configs. Returns
    the parsed dict (for e.g. regression.threshold_percent).
    """
    import dataclasses

    import yaml

    global CENTER_CROP, BORDER
    cfg = yaml.safe_load(Path(path).read_text()) or {}
    for cat, (p, w) in (cfg.get("thresholds") or {}).items():
        THRESHOLDS[cat] = (float(p), float(w))
    PATTERN_CATEGORIES.update(cfg.get("pattern_categories") or {})
    region = cfg.get("test_region") or {}
    CENTER_CROP = int(region.get("center_crop", CENTER_CROP))
    BORDER = int(region.get("border", BORDER))
    for name, pc in (cfg.get("pyramid_configs") or {}).items():
        base = PYRAMID_CONFIGS.get(name, PYRAMID_CONFIGS["default"])
        PYRAMID_CONFIGS[name] = dataclasses.replace(base, **pc)
    return cfg


def get_test_region_mask(
    shape: Tuple[int, int], pattern_name: str, center_crop: Optional[int] = None
) -> np.ndarray:
    """Mask of pixels to score (reference: optical_flow_verifier.py:96-138)."""
    if center_crop is None:
        center_crop = CENTER_CROP  # module global: --config can override
    height, width = shape
    mask = np.zeros((height, width), dtype=bool)
    varies = (
        "rotate" in pattern_name
        or "zoom" in pattern_name
        or "translate_rotate" in pattern_name
    )
    if varies:
        cy, cx = height // 2, width // 2
        half = center_crop // 2
        mask[cy - half : cy + half, cx - half : cx + half] = True
    else:
        mask[BORDER:-BORDER, BORDER:-BORDER] = True
    return mask


def classify_result(mae_u: float, mae_v: float, pattern_name: str) -> str:
    """Pass/Warning/Fail on worst-case component MAE (reference:
    optical_flow_verifier.py:175-203)."""
    category = PATTERN_CATEGORIES.get(pattern_name, "translation")
    mae_pass, mae_warning = THRESHOLDS[category]
    mae_max = max(mae_u, mae_v)
    if mae_max <= mae_pass:
        return "Pass"
    if mae_max <= mae_warning:
        return "Warning"
    return "Fail"


def _make_runners(
    pyramid_config: PyramidConfig, backend: str, gaussian_weights: bool = False
):
    """Build jitted single-scale and pyramidal runners (compiled once,
    reused across all 13 patterns — same shapes)."""
    import jax

    from tpuflow.flow import lucas_kanade_pyramidal, lucas_kanade_single_scale

    @jax.jit
    def single(prev, curr):
        return lucas_kanade_single_scale(
            prev, curr, pyramid_config.window_size,
            gaussian_weights=gaussian_weights,
        )

    @jax.jit
    def pyramidal(prev, curr):
        return lucas_kanade_pyramidal(prev, curr, config=pyramid_config, backend=backend)

    return single, pyramidal


def verify_pattern(
    pattern_name: str,
    pattern_data: Dict[str, Any],
    runners,
    pyramid_config_name: str = "default",
    verbose: bool = True,
    dense_gt: bool = False,
) -> Dict[str, Any]:
    """Run both implementations on one pattern and score them (reference:
    optical_flow_verifier.py:211-312).

    ``dense_gt`` adds an extra per-mode ``dense_metrics`` block scored
    against the exact per-pixel affine flow field
    (tpuflow.eval.patterns.dense_ground_truth) — meaningful spatial
    ground truth for rotation/zoom/combined patterns, which the scalar
    (dx, dy) convention only describes at the frame center. Opt-in; not
    part of the baseline regression gate.
    """
    single, pyramidal = runners
    frame_prev = pattern_data["frame_prev"]
    frame_curr = pattern_data["frame_curr"]
    motion = pattern_data["metadata"]["motion_parameters"]
    u_true, v_true = motion["dx"], motion["dy"]

    mask = get_test_region_mask(frame_prev.shape, pattern_name)

    u_s, v_s = single(frame_prev, frame_curr)
    metrics_single = compute_all_metrics(
        np.asarray(u_s), np.asarray(v_s), u_true, v_true, mask
    )
    u_p, v_p = pyramidal(frame_prev, frame_curr)
    metrics_pyr = compute_all_metrics(
        np.asarray(u_p), np.asarray(v_p), u_true, v_true, mask
    )

    dense_single = dense_pyr = None
    if dense_gt:
        from tpuflow.eval.metrics import compute_all_metrics_dense

        h, w = frame_prev.shape
        mp = patterns_mod.MotionParameters(
            **{
                k: motion[k]
                for k in ("name", "dx", "dy", "rotation", "scale",
                          "description")
                if k in motion
            }
        )
        gu, gv, visible = patterns_mod.dense_ground_truth(mp, w, h)
        dmask = mask & visible
        dense_single = compute_all_metrics_dense(
            np.asarray(u_s), np.asarray(v_s), gu, gv, dmask
        )
        dense_pyr = compute_all_metrics_dense(
            np.asarray(u_p), np.asarray(v_p), gu, gv, dmask
        )

    status_single = classify_result(
        metrics_single["mae_u"], metrics_single["mae_v"], pattern_name
    )
    status_pyr = classify_result(metrics_pyr["mae_u"], metrics_pyr["mae_v"], pattern_name)

    if verbose:
        print(
            f"{pattern_name:22s} single: mae=({metrics_single['mae_u']:.3f},"
            f"{metrics_single['mae_v']:.3f}) epe={metrics_single['epe']:.3f}"
            f" [{status_single}]  pyramidal: mae=({metrics_pyr['mae_u']:.3f},"
            f"{metrics_pyr['mae_v']:.3f}) epe={metrics_pyr['epe']:.3f} [{status_pyr}]"
        )

    out_single: Dict[str, Any] = {
        "metrics": metrics_single, "status": status_single,
    }
    out_pyr: Dict[str, Any] = {
        "metrics": metrics_pyr,
        "status": status_pyr,
        "config": pyramid_config_name,
    }
    if dense_single is not None:
        out_single["dense_metrics"] = dense_single
        out_pyr["dense_metrics"] = dense_pyr
    return {
        "pattern_name": pattern_name,
        "ground_truth": {"u": u_true, "v": v_true},
        "num_test_pixels": int(mask.sum()),
        "single_scale": out_single,
        "pyramidal": out_pyr,
        "flow_fields": {
            "single": (np.asarray(u_s), np.asarray(v_s)),
            "pyramidal": (np.asarray(u_p), np.asarray(v_p)),
        },
    }


def _strip_arrays(result: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in result.items() if k != "flow_fields"}


# ---------------------------------------------------------------------------
# Baseline regression (reference: optical_flow_verifier.py:572-735)
# ---------------------------------------------------------------------------


def compare_metrics(
    current: Dict[str, float],
    baseline: Dict[str, float],
    threshold_percent: float = 10.0,
) -> Dict[str, Any]:
    """Flag mae_u/mae_v/epe changes beyond the threshold (reference:
    optical_flow_verifier.py:586-634), including the baseline-zero rule."""
    differences: Dict[str, Any] = {}
    flags: List[str] = []
    for metric in ("mae_u", "mae_v", "epe"):
        curr_val = current.get(metric, 0.0)
        base_val = baseline.get(metric, 0.0)
        if base_val < 1e-6:
            if curr_val > 1e-6:
                flags.append(f"{metric}: {curr_val:.4f} (baseline was 0)")
            continue
        change = 100.0 * (curr_val - base_val) / base_val
        differences[metric] = {
            "current": curr_val,
            "baseline": base_val,
            "change_percent": change,
        }
        if abs(change) > threshold_percent:
            flags.append(
                f"{metric}: {change:+.1f}% change "
                f"(current={curr_val:.4f}, baseline={base_val:.4f})"
            )
    return {"passed": not flags, "differences": differences, "flags": flags}


def compare_against_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path,
    threshold_percent: float = 10.0,
    verbose: bool = True,
    backend: str | None = None,
) -> bool:
    """Whole-suite regression check; True = no regressions (reference:
    optical_flow_verifier.py:637-719).

    Provenance guard: a baseline captured with one pyramid config or
    flow semantics must not silently gate a run of another (e.g. a fast
    backend against the jnp reference baseline, or ``narrow_vertical``
    against the full-band fast baseline) — mismatches fail the check
    outright instead of producing spurious metric flags or accidental
    passes. The fast backends (``xla``, ``pallas``) share one semantics,
    so either gates against a baseline captured with the other."""
    if not baseline_path.exists():
        print(f"No baseline found at {baseline_path}; skipping regression check.")
        return True
    doc = json.loads(baseline_path.read_text())
    baseline = doc.get("patterns", {})
    base_backend = doc.get("backend")
    if (
        backend is not None
        and base_backend is not None
        and is_clamped(backend) != is_clamped(base_backend)
    ):
        print(
            f"PROVENANCE MISMATCH: baseline {baseline_path.name} was "
            f"captured with backend={base_backend!r} but this run uses "
            f"backend={backend!r}; pass the matching --baseline."
        )
        return False

    all_passed = True
    for result in results:
        name = result["pattern_name"]
        if name not in baseline:
            if verbose:
                print(f"  {name}: not in baseline (skipping)")
            continue
        run_cfg = result.get("pyramidal", {}).get("config")
        base_cfg = baseline[name].get("pyramidal", {}).get("config")
        if run_cfg is not None and base_cfg is not None and run_cfg != base_cfg:
            print(
                f"  PROVENANCE MISMATCH {name}: baseline pyramid config "
                f"{base_cfg!r} != run config {run_cfg!r}"
            )
            all_passed = False
            continue
        for mode in ("single_scale", "pyramidal"):
            cmp = compare_metrics(
                result[mode]["metrics"],
                baseline[name][mode]["metrics"],
                threshold_percent,
            )
            if not cmp["passed"]:
                all_passed = False
                if verbose:
                    print(f"  REGRESSION {name} ({mode}):")
                    for flag in cmp["flags"]:
                        print(f"    - {flag}")
    if verbose:
        print(
            "Regression check: "
            + ("all patterns within threshold" if all_passed else "FAILURES detected")
        )
    return all_passed


def update_baseline(
    results: List[Dict[str, Any]],
    baseline_path: Path,
    backend: str | None = None,
) -> None:
    """Rewrite the baseline from current results (reference:
    optical_flow_verifier.py:722-735). ``backend`` records the capture
    provenance checked by ``compare_against_baseline``."""
    data = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "patterns": {r["pattern_name"]: _strip_arrays(r) for r in results},
    }
    if backend is not None:
        data["backend"] = backend
    baseline_path.parent.mkdir(parents=True, exist_ok=True)
    baseline_path.write_text(json.dumps(data, indent=2))
    print(f"Baseline updated: {baseline_path}")


# ---------------------------------------------------------------------------
# Reports (reference: optical_flow_verifier.py:320-386)
# ---------------------------------------------------------------------------


def generate_markdown_table(results: List[Dict[str, Any]]) -> str:
    lines = ["# Optical Flow Verification Results\n"]
    for mode, title in (
        ("single_scale", "Single-Scale Lucas-Kanade"),
        ("pyramidal", "Pyramidal Lucas-Kanade"),
    ):
        lines.append(f"## {title}\n")
        lines.append(
            "| Pattern | Ground Truth | MAE (u) | MAE (v) | RMSE | EPE | AAE | Status |"
        )
        lines.append(
            "|---------|--------------|---------|---------|------|-----|-----|--------|"
        )
        for r in results:
            gt = r["ground_truth"]
            m = r[mode]["metrics"]
            lines.append(
                f"| {r['pattern_name']:20s} | ({gt['u']:4.1f}, {gt['v']:4.1f}) | "
                f"{m['mae_u']:5.3f} | {m['mae_v']:5.3f} | {m['rmse']:5.3f} | "
                f"{m['epe']:5.3f} | {m['aae']:5.2f}° | {r[mode]['status']} |"
            )
        lines.append("")

    if any("dense_metrics" in r["single_scale"] for r in results):
        lines.append("## Dense Ground Truth (exact per-pixel affine field)\n")
        lines.append(
            "| Pattern | Mode | MAE (u) | MAE (v) | RMSE | EPE | AAE |"
        )
        lines.append(
            "|---------|------|---------|---------|------|-----|-----|"
        )
        for r in results:
            for mode, label in (
                ("single_scale", "single"), ("pyramidal", "pyramidal"),
            ):
                m = r[mode].get("dense_metrics")
                if m is None:
                    continue
                lines.append(
                    f"| {r['pattern_name']:20s} | {label:9s} | "
                    f"{m['mae_u']:5.3f} | {m['mae_v']:5.3f} | "
                    f"{m['rmse']:5.3f} | {m['epe']:5.3f} | {m['aae']:5.2f}° |"
                )
        lines.append("")
    return "\n".join(lines)


def save_results_json(results: List[Dict[str, Any]], output_path: Path) -> None:
    data = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "patterns": {r["pattern_name"]: _strip_arrays(r) for r in results},
    }
    output_path.parent.mkdir(parents=True, exist_ok=True)
    output_path.write_text(json.dumps(data, indent=2))


# ---------------------------------------------------------------------------
# Suite runner / CLI (reference: optical_flow_verifier.py:743-919)
# ---------------------------------------------------------------------------


def run_suite(
    suite_dir: Optional[Path] = None,
    pattern_names: Optional[List[str]] = None,
    pyramid_config_name: str = "default",
    backend: str = "jnp",
    verbose: bool = True,
    gaussian_weights: bool = False,
    dense_gt: bool = False,
) -> List[Dict[str, Any]]:
    """Run verification over the suite, generating it first if missing."""
    suite_dir = Path(suite_dir) if suite_dir else patterns_mod.DEFAULT_SUITE_DIR
    if not (suite_dir / "suite_index.json").exists():
        if verbose:
            print(f"Generating test suite -> {suite_dir}")
        patterns_mod.generate_full_suite(output_dir=suite_dir)

    index = json.loads((suite_dir / "suite_index.json").read_text())
    available = set(index["patterns"].keys())
    if pattern_names:
        unknown = [n for n in pattern_names if n not in available]
        if unknown:
            raise SystemExit(
                f"Unknown pattern(s): {', '.join(unknown)}. "
                f"Available: {', '.join(sorted(available))}"
            )
    names = pattern_names or list(index["patterns"].keys())

    cfg = PYRAMID_CONFIGS[pyramid_config_name]
    runners = _make_runners(cfg, backend, gaussian_weights)

    results = []
    for name in names:
        data = patterns_mod.load_test_pattern(suite_dir / name)
        results.append(
            verify_pattern(
                name, data, runners, pyramid_config_name, verbose=verbose,
                dense_gt=dense_gt,
            )
        )
    return results


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Verify tpuflow optical flow against the 13-pattern suite"
    )
    parser.add_argument("--suite-dir", type=str, default=None)
    parser.add_argument("--pattern", type=str, nargs="+", default=None)
    parser.add_argument(
        "--pyramid-config", type=str, default="default",
        help=f"named pyramid config (built-in: {', '.join(sorted(PYRAMID_CONFIGS))}; "
        "--config can add more)",
    )
    parser.add_argument("--backend", type=str, default="jnp", choices=BACKENDS)
    parser.add_argument(
        "--gaussian-weights", action="store_true",
        help="Gaussian window weighting for single-scale (the option the "
        "reference documents but never implemented, README.md:126-129; "
        "note the committed baselines are unweighted)",
    )
    parser.add_argument(
        "--config", type=str, default=None, metavar="YAML",
        help="verifier config overriding thresholds/categories/test "
        "region/pyramid configs (reference verification_config.yaml "
        f"analog; defaults shipped at {DEFAULT_CONFIG.name})",
    )
    parser.add_argument("--compare-baseline", action="store_true")
    parser.add_argument("--update-baseline", action="store_true")
    parser.add_argument("--regression-threshold", type=float, default=None)
    parser.add_argument(
        "--baseline",
        type=str,
        default=str(REFERENCE_BASELINE),
        help="Baseline JSON (defaults to the reference repo's committed baseline)",
    )
    parser.add_argument("--output-dir", type=str, default="results")
    parser.add_argument("--no-visualizations", action="store_true")
    parser.add_argument(
        "--dense-gt", action="store_true",
        help="add metrics columns against the exact per-pixel affine "
        "flow field (meaningful spatial ground truth for rotation/zoom/"
        "combined patterns; extra report section, not gated)",
    )
    args = parser.parse_args()

    file_cfg = apply_config(args.config) if args.config else {}
    if args.regression_threshold is None:
        args.regression_threshold = float(
            (file_cfg.get("regression") or {}).get("threshold_percent", 10.0)
        )
    if args.pyramid_config not in PYRAMID_CONFIGS:
        raise SystemExit(
            f"Unknown pyramid config '{args.pyramid_config}'. "
            f"Available: {', '.join(sorted(PYRAMID_CONFIGS))}"
        )

    results = run_suite(
        suite_dir=Path(args.suite_dir) if args.suite_dir else None,
        pattern_names=args.pattern,
        pyramid_config_name=args.pyramid_config,
        backend=args.backend,
        gaussian_weights=args.gaussian_weights,
        dense_gt=args.dense_gt,
    )

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    md = generate_markdown_table(results)
    (out_dir / "verification_results.md").write_text(md)
    save_results_json(results, out_dir / "verification_results.json")
    print("\n" + md)

    if not args.no_visualizations:
        try:
            import jax.numpy as jnp

            from tpuflow.eval import visualize
            from tpuflow.flow import lucas_kanade_pyramidal

            suite = Path(args.suite_dir) if args.suite_dir \
                else patterns_mod.DEFAULT_SUITE_DIR
            cfg = PYRAMID_CONFIGS[args.pyramid_config]
            for r in results:
                if r["pattern_name"] in ("translate_medium", "rotate_small",
                                         "translate_extreme"):
                    visualize.save_pattern_plots(r, out_dir / "plots")
                    # Per-pyramid-level snapshots (reference
                    # visualize_pyramid_level analog — the reference's
                    # viz pass re-runs the solver too).
                    data = patterns_mod.load_test_pattern(
                        suite / r["pattern_name"]
                    )
                    _, _, levels = lucas_kanade_pyramidal(
                        jnp.asarray(data["frame_prev"]),
                        jnp.asarray(data["frame_curr"]),
                        config=cfg, backend=args.backend,
                        return_levels=True,
                    )
                    visualize.save_pyramid_levels(
                        levels,
                        out_dir / "plots" / r["pattern_name"] / "levels",
                    )
        except Exception as exc:  # matplotlib optional
            print(f"(visualizations skipped: {exc})")

    if args.update_baseline:
        update_baseline(results, Path(args.baseline), backend=args.backend)

    if args.compare_baseline:
        ok = compare_against_baseline(
            results, Path(args.baseline), args.regression_threshold,
            backend=args.backend,
        )
        if not ok:
            print("\nRegression detected! Review changes before committing.")
            sys.exit(1)


if __name__ == "__main__":
    main()
