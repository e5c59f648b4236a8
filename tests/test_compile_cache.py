"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins when set, and
nothing is set in code; otherwise the cache is <repo>/.jax_cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import os, jax, jax.numpy as jnp
from sip_optimal_control_tpu.utils import enable_compile_cache
print("SET", enable_compile_cache())
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(7.0)).block_until_ready()
print("DIR", jax.config.jax_compilation_cache_dir)
"""


def _run(tmp_path, cache_env):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0", **cache_env)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return dict(line.split(" ", 1) for line in out.stdout.splitlines())


def test_env_var_set_lands_there_and_code_sets_nothing(tmp_path):
    cache = tmp_path / "cache"
    got = _run(tmp_path, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert got == {"SET": "None", "DIR": str(cache)}
    assert any(cache.iterdir()), "no cache entry written"


def test_env_var_unset_uses_repo_cache(tmp_path):
    got = _run(tmp_path, {})
    assert got == {"SET": os.path.join(REPO, ".jax_cache"),
                   "DIR": os.path.join(REPO, ".jax_cache")}
