"""Where JAX keeps its persistent compilation cache, for every entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is configured here. Otherwise the cache goes to ``<checkout>/.cache/jax``,
resolved from this package's own location: a fixed path, because the
path is part of the cache key and a moving directory never hits.
"""

import os

ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'


def default_dir() -> str:
    """``<checkout>/.cache/jax`` for the checkout this package lives in."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), '.cache', 'jax')


def configure() -> str:
    """Point JAX's persistent cache at the right directory; returns it."""
    import jax
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    path = default_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    return path
