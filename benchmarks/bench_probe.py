"""Instrumented single-step benchmark probe: prints phase timings so slow or hung
compiles can be localized.  Usage: python benchmarks/bench_probe.py [N]."""

import sys
import time

t0 = time.time()


def log(msg):
    print(f"[{time.time() - t0:8.1f}s] {msg}", flush=True)


import os  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
try:
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get("JAX_COMPILATION_CACHE_DIR", "/root/repo/.jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
except Exception:
    pass
sys.path.insert(0, "/root/repo")

import __graft_entry__ as g  # noqa: E402
from gple_tpu.parallel.sharding import make_step_fn  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    log(f"devices: {jax.devices()}")
    log(f"building example state N={n}")
    density, gps = g._example_state(n)
    jax.block_until_ready(density)
    jax.block_until_ready(gps)
    log("state ready (fit compiled + ran)")
    step = jax.jit(make_step_fn("SAC", 2000.0, 1.0))
    out = step(density, gps)
    jax.block_until_ready(out)
    log("step compiled + ran once")
    t1 = time.time()
    for _ in range(5):
        out = step(*out)
    jax.block_until_ready(out)
    log(f"5 steps: {(time.time() - t1) / 5 * 1000:.3f} ms/step")


if __name__ == "__main__":
    main()
