"""Two-process jax.distributed bring-up on localhost — the executable
evidence for sharding.mesh.initialize_multihost (without it the
wrapper would never execute a multi-process init anywhere).

Each worker subprocess forces the CPU platform, exposes 4 local CPU
devices, calls initialize_multihost against a localhost coordinator,
builds the GLOBAL 8-device mesh, and runs a psum across all devices —
including the process boundary, which is exactly the cross-host leg
of a multi-host deployment. Workers are separate interpreters (subprocess), not
threads: jax.distributed state is per-process."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

WORKER = textwrap.dedent(
    """
    import json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)

    sys.path.insert(0, "@REPO@")
    from tpuflow.sharding.mesh import initialize_multihost

    pid = int(sys.argv[1])
    did_init = initialize_multihost(
        coordinator_address="localhost:@PORT@", num_processes=2,
        process_id=pid,
    )
    # Re-entry must be an idempotent no-op, not an error.
    assert initialize_multihost(
        coordinator_address="localhost:@PORT@", num_processes=2,
        process_id=pid,
    ) is False

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.process_count() == 2
    assert len(jax.devices()) == 8  # global across both processes
    assert len(jax.local_devices()) == 4

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("host", "chip"))
    sharding = NamedSharding(mesh, P("host", "chip"))
    # Each process contributes its local shard of a (2, 4) global array;
    # the jitted global psum must see every element, i.e. the collective
    # crossed the process boundary.
    local = np.arange(4, dtype=np.float32)[None, :] + 10.0 * pid
    arr = jax.make_array_from_process_local_data(sharding, local, (2, 4))
    total = jax.jit(
        lambda x: jnp.sum(x), out_shardings=NamedSharding(mesh, P())
    )(arr)
    expected = float(sum(range(4)) + sum(10.0 + i for i in range(4)))
    # The fully-replicated output is addressable on every process; its
    # value can only be correct if the sum crossed the process boundary.
    got = float(np.asarray(total.addressable_data(0)))
    print(json.dumps({
        "pid": pid, "did_init": bool(did_init), "sum": got,
        "expected": expected,
        "ok": abs(got - expected) < 1e-6,
    }))
    """
)


@pytest.mark.slow
def test_two_process_initialize_multihost(tmp_path):
    repo = str(Path(__file__).resolve().parent.parent)
    # Ephemeral port per invocation: parallel test shards on the same
    # machine must not collide on the coordinator bind. The
    # throwaway bind reserves nothing, but the kernel cycles ephemeral
    # ports, so a clash within the test's lifetime is vanishingly rare.
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(
        WORKER.replace("@REPO@", repo).replace("@PORT@", str(port))
    )
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out (coordinator hang?)")
        assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
        # Gloo logs "[Gloo] Rank N is connected ..." on STDOUT, racing
        # the JSON line (sometimes trailing it) — find the JSON line
        # rather than assuming it is last.
        json_lines = [
            ln for ln in out.splitlines() if ln.startswith("{")
        ]
        assert json_lines, f"no JSON line in worker output:\n{out[-2000:]}"
        outs.append(json.loads(json_lines[-1]))
    for o in outs:
        assert o["ok"], o
        assert o["did_init"] is True
    assert {o["pid"] for o in outs} == {0, 1}
