"""Test configuration: the CPU backend with fp64.

Correctness tests run in float64 on CPU (matching the reference's fp64
accuracy bars).  Pallas kernels run in interpret mode here.  Sharding
tests spawn subprocesses that set their own virtual device count.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# NOTE: --xla_force_host_platform_device_count is deliberately NOT set here:
# it slows every XLA:CPU compile ~7x.  Sharding tests (test_sharding.py)
# spawn a subprocess that sets it for themselves.

import jax  # noqa: E402

from sip_optimal_control_tpu.utils import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# XLA:CPU compiles of scan+cholesky programs are slow; cache them across
# test runs (see utils/compile_cache.py for where).
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
