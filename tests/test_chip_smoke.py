"""chip_smoke.py refuses to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _printed_result(stdout):
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except ValueError:
            pass
    return False


def test_fails_on_cpu_backend():
    res = _run(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "needs a GPU" in res.stderr


def test_fails_without_the_package(tmp_path):
    """Alone in a directory (no package beside it) the script exits
    non-zero and prints no result."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", script)
    res = _run(tmp_path, script)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


@pytest.mark.gpu
def test_device_resident_is_the_gpu_default(gpu, monkeypatch):
    """On a GPU backend an eligible chunk runs device-resident with no
    environment variable set."""
    from glimmer_mg_tpu.engine import glimmer_mg as mg

    monkeypatch.delenv("GLIMMER_MG_TPU_DEVICE_DP", raising=False)
    assert mg._use_device_dp()
