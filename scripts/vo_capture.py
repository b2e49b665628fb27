"""Capture a VO trajectory-suite run to JSON (baseline recapture /
cross-platform calibration helper).

Usage:
    python scripts/vo_capture.py out.json [--cpu] [--backend jnp|xla|pallas]
        [--pyramid-config NAME]

Writes the same document shape as vo_verifier.update_baseline, with
backend/platform/pyramid_config provenance recorded.
"""

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpuflow.compile_cache import setup_compile_cache  # noqa: E402
from tpuflow.flow.backend import BACKENDS  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--backend", default="jnp", choices=BACKENDS)
    ap.add_argument("--pyramid-config", default="default")
    args = ap.parse_args()

    setup_compile_cache()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from tpuflow.eval import vo_verifier

    platform = jax.default_backend()
    results = vo_verifier.run_suite(
        backend=args.backend, pyramid_config=args.pyramid_config
    )
    doc = {
        "version": "1.0",
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "sequences": {r["sequence"]: r for r in results},
        "backend": args.backend,
        "platform": platform,
        "pyramid_config": args.pyramid_config,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(f"wrote {args.out} (platform={platform})")


if __name__ == "__main__":
    sys.exit(main())
