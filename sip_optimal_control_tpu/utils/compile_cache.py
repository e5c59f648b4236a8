"""Where the persistent XLA compilation cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself.  When it is set, nothing
here touches the cache configuration.  When it is not, the cache goes to
``.jax_cache`` at the root of this checkout, a fixed path, so repeated runs
of the repository's scripts find their compiled programs again.
"""

from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Point JAX at `DEFAULT_DIR` unless the environment names a cache.
    Returns the directory this call configured, or None if it set
    nothing."""
    if os.environ.get(ENV_VAR):
        return None
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
