"""Headline benchmark: GPR fit+evolve wall time per step at N = 1024.

One step = the per-tick work of the reference main loop (main.cpp:135-202):
evolve every sampled point of all three density-matrix elements through the
branching backward predictor (9 GP queries per point), then refactorize all
element GPs from the moved points.

``vs_baseline`` is the speedup of the GPU run over the SAME jitted step
executed on the host CPU backend, measured in a child process that never
opens the card -- a stand-in for the reference's Eigen+MKL CPU
implementation (identical asymptotics: O(N^3) factorization per element per
step plus O(N) GP queries per point).

A run that finds no GPU exits non-zero.

Usage: python bench.py [--quick] [-n N] [--steps K]
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import subprocess
import sys
import time


def _setup_jax(force_cpu: bool = False):
    import jax

    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from gple_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()


def measure(step_fn, args, n_steps):
    """Time ``n_steps`` feed-forward steps in ONE device dispatch.

    The steps run as a ``lax.scan`` chunk (the production driver's execution
    shape, driver._ticks_scan), so the measurement is device-bound and immune
    to host-side dispatch jitter.  The warm-up uses the same static length,
    so the timed dispatch hits the compiled program."""
    import jax

    def chunk(carry, _):
        return step_fn(*carry), None

    def run_chunk(carry, length):
        out, _ = jax.lax.scan(chunk, carry, None, length=length)
        return out

    run = jax.jit(run_chunk, static_argnums=1)
    out = jax.block_until_ready(run(args, n_steps))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(out, n_steps))
    return (time.perf_counter() - t0) / n_steps, out


def bench(n_points: int, n_steps: int, force_cpu: bool = False) -> float:
    """Seconds per step on the current backend."""
    _setup_jax(force_cpu)
    import jax

    import __graft_entry__ as g
    from gple_tpu.parallel.sharding import make_step_fn

    step = make_step_fn("SAC", 2000.0, 1.0)
    density, gps = g._example_state(n_points)
    sec, out = measure(jax.jit(step), (density, gps), n_steps)
    assert bool(jax.numpy.isfinite(out[0].rho).all())
    return sec


def _cpu_baseline(n_points: int, n_steps: int, timeout_s: float = 2400.0) -> float:
    """Host-CPU step time for ``vs_baseline``, from a CPU-only child."""
    try:
        r = subprocess.run(
            [sys.executable, __file__, "--cpu-probe", "-n", str(n_points),
             "--steps", str(n_steps)],
            timeout=timeout_s, capture_output=True, text=True,
        )
        if r.returncode == 0:
            return float(r.stdout.strip().splitlines()[-1])
    except (subprocess.TimeoutExpired, OSError, ValueError, IndexError):
        pass
    return float("nan")


def card_name_power() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small N for smoke runs")
    ap.add_argument("-n", type=int, default=None, help="points per element")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--cpu-probe", action="store_true",
                    help="internal: print the host-CPU step time and exit")
    opts = ap.parse_args()
    n = opts.n or (256 if opts.quick else 1024)
    steps = opts.steps or (3 if opts.quick else 10)

    if opts.cpu_probe:
        print(bench(n, steps, force_cpu=True))
        return 0

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    card = card_name_power()
    sec_gpu = bench(n, steps)
    sec_cpu = _cpu_baseline(n, max(1, steps // 4))
    print(card)
    print(json.dumps({
        "metric": f"GPR fit+evolve sec/step @ N={n}",
        "value": sec_gpu,
        "unit": "s/step",
        # null (not 1.0) when the CPU baseline was not measured
        "vs_baseline": sec_cpu / sec_gpu if sec_cpu == sec_cpu else None,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
