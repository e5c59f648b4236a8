"""Entry points that need accelerators refuse to run without them: no
silent fallback to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_fast_without_gpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_dryrun_multichip_raises_with_too_few_devices():
    import jax
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs"):
        dryrun_multichip(len(jax.devices()) + 1)
