"""Device-mesh construction for tiled dense flow.

The reference is a single-chip design; its "parallelism" is spatial
(125 DSP multiplies/cycle, per-level solver pipelines — SURVEY.md §2.6).
The scale-out analog is a 2-D spatial tiling of the frame across a
device mesh, optionally with a leading data-parallel axis over frame
pairs, with XLA collectives between the devices of a host (NVLink
between GPUs) and across hosts via jax.distributed (see
``initialize_multihost``).

Mesh axes:
    "batch" — data parallel over independent frame pairs/streams
    "ty"    — image-row tiling
    "tx"    — image-column tiling
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_flow_mesh(
    batch: int = 1,
    ty: int = 1,
    tx: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a ("batch", "ty", "tx") mesh from the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = batch * ty * tx
    if len(devices) < n:
        raise ValueError(
            f"mesh ({batch}x{ty}x{tx}) needs {n} devices, have {len(devices)}"
        )
    arr = np.array(devices[:n]).reshape(batch, ty, tx)
    return Mesh(arr, ("batch", "ty", "tx"))


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize cross-host JAX — call once per process before any
    device computation on multi-host deployments.

    Returns True when this call initialized the runtime, False when it
    was already initialized (idempotent re-entry). Any other failure
    raises — a multi-host deployment with a broken coordinator must not
    silently fall back to single-process.

    Exercised for real (two local processes over a localhost
    coordinator, global 2x4-device CPU mesh, cross-process psum) by
    tests/test_multihost.py — the closest this single-host rig can get
    to a cross-host bring-up.
    """
    if jax.distributed.is_initialized():
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
