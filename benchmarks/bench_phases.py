"""Phase-level timing of the flagship step: fit vs evolve vs observables.

Usage: python benchmarks/bench_phases.py [N]
"""

import sys
import time

t0 = time.time()


def log(msg):
    print(f"[{time.time() - t0:8.1f}s] {msg}", flush=True)


import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
sys.path.insert(0, "/root/repo")

import __graft_entry__ as g  # noqa: E402
from gple_tpu.dynamics.evolve import evolve_step  # noqa: E402
from gple_tpu.driver import gp_dist_all  # noqa: E402
from gple_tpu.storage import fit_gp_states  # noqa: E402


def timeit(label, fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    log(f"{label}: compiled")
    t1 = time.time()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    log(f"{label}: {(time.time() - t1) / reps * 1000:.3f} ms")
    return out


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    log(f"N={n} on {jax.devices()}")
    density, gps = g._example_state(n)
    jax.block_until_ready(gps)
    log("state ready")

    fit = jax.jit(lambda d: fit_gp_states(gps.diag.params, gps.offdiag.params, d))
    timeit("fit_gp_states", fit, density)

    ev = jax.jit(
        lambda d, s: evolve_step("SAC", 2000.0, 1.0, d, gp_dist_all, s)
    )
    timeit("evolve_step", ev, density, gps)

    obs = jax.jit(lambda s: (s.population(), s.purity()))
    timeit("observables", obs, gps)


if __name__ == "__main__":
    main()
