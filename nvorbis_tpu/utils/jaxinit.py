"""One-time jax configuration applied at first device-plane use.

Enables the persistent compilation cache so a library user's second
process never re-pays XLA compiles.  Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: jax reads it itself and no code
  here (or in ``bench.py`` / ``chip_smoke.py``) sets another;
- otherwise ``<checkout>/.jax_cache``, derived from this file's own path,
  so every process of one checkout shares it.

A ``jax_compilation_cache_dir`` already set by the embedding application
also wins.  ``NVT_NO_COMPILE_CACHE=1`` disables the cache entirely.
"""

import os

_done = False


def cache_dir() -> str:
    """The compile-cache directory this checkout uses (jax-free)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def ensure_compile_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    # same trigger point (first device-plane use), same spirit (one-time
    # process-level setup a library user should not have to know about):
    # recycle host pages instead of re-faulting them (see utils/hostmem.py)
    from nvorbis_tpu.utils.hostmem import enable_page_recycling

    enable_page_recycling()
    if os.environ.get("NVT_NO_COMPILE_CACHE", "") not in ("", "0"):
        return
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    path = cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # cache is an optimization; never block a decode on it
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
