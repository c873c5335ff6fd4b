"""Persistent XLA compilation cache and the checkout's state directory.

First compiles of the big jitted graphs (the tick chunk, the optimizer
ladder, the MC tuning scans) cost seconds to minutes.  The persistent cache
amortizes them across processes, so the second run of any entry point
(driver, CLI, bench, parity) starts hot.  The reference has no equivalent
concern (its C++ is compiled once by make).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache is exactly that
directory.  Otherwise it is ``<checkout>/.jax_cache``, with CPU entries in a
per-host subdirectory.  Files the driver keeps between runs that are not
compiled programs (the init-state cache) live in ``<checkout>/.gple_state``.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")
STATE_DIR = os.path.join(_CHECKOUT, ".gple_state")

#: only compiles slower than this are persisted.  CPU: caching sub-second
#: entries floods the directory with thousands of trivial-op files whose
#: write/read traffic costs more than it saves.  GPU: every compile -- a cold
#: ``chip_smoke.py`` on an H100 ran 625 XLA compiles, 49.7 s of them in
#: compiles under 1 s, which a 1 s threshold would repeat on every run.
MIN_COMPILE_SECS = {"cpu": 1.0, "gpu": 0.0}


def _host_tag() -> str:
    """A per-host fingerprint for CPU cache entries.

    XLA:CPU AOT cache entries bake in the compile host's CPU features;
    loading them on a different machine logs cpu_aot_loader SIGILL-hazard
    errors.  Keying the CPU cache subdirectory by a hash of the host's
    cpuinfo flags keeps cross-host entries out while still amortizing
    compiles across processes on the SAME machine."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as fh:
            flags = next((ln for ln in fh if ln.startswith("flags")), "")
    except OSError:
        flags = ""
    return hashlib.sha1(flags.encode()).hexdigest()[:12]


def cache_settings(backend: str, cache_dir: str | None = None) -> dict:
    """The jax config values :func:`enable_persistent_cache` sets on
    ``backend``: the directory, the min-compile-time threshold and the size
    bound."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache_dir is not None:
        target = cache_dir
    elif env:
        target = env
    elif backend == "cpu":
        target = os.path.join(_DEFAULT_DIR, f"cpu-{_host_tag()}")
    else:
        target = _DEFAULT_DIR
    return {
        "jax_compilation_cache_dir": target,
        "jax_persistent_cache_min_compile_time_secs":
            MIN_COMPILE_SECS.get(backend, MIN_COMPILE_SECS["gpu"]),
        # LRU-bound the directory: stale programs from superseded code
        # versions never age out on their own (every edit changes the key)
        "jax_compilation_cache_max_size": 4 * 1024**3,
    }


def enable_persistent_cache(cache_dir: str | None = None) -> None:
    """Point JAX's persistent compilation cache at ``cache_dir`` (default:
    see :func:`cache_settings`).  Safe to call multiple times."""
    import jax

    for name, value in cache_settings(jax.default_backend(), cache_dir).items():
        jax.config.update(name, value)
