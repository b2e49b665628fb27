"""chip_smoke.py on the CPU: the rehearsal of every phase at tiny sizes
(the kernel interpreted), and the refusals that keep a run without a GPU
from printing a result."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize(
    "argv, phases",
    [
        (["--rehearse"], ["device", "kernel_check", "flow_1080p", "flow_4K",
                          "vo_1080p"]),
        (["--rehearse", "--four"], ["device", "four_devices"]),
    ],
)
def test_rehearsal_passes_every_phase(argv, phases, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    assert chip_smoke.main(argv) == 0
    records = _records(capsys.readouterr().out)
    ran = [r for r in records if "phase" in r]
    assert [r["name"] for r in ran] == phases
    assert all(r["ok"] for r in ran)
    # A rehearsal never ends with the result line the chip run prints.
    assert records[-1]["rehearsal"] == "passed"
    assert "ok" not in records[-1]


def test_fails_without_gpu(capsys):
    if jax.devices()[0].platform == "gpu":
        pytest.skip("this test checks the refusal without a GPU")
    assert chip_smoke.main([]) == 1
    records = _records(capsys.readouterr().out)
    assert records[-1]["phase"] == 0 and records[-1]["ok"] is False
    assert not any(r.get("ok") is True and "device" in r and "phase" not in r
                   for r in records)


def test_fails_alone(tmp_path):
    """In a directory holding nothing else of the repo the script stops
    before it opens JAX, with a non-zero exit and no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
