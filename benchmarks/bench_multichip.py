"""Multi-chip scaling of the sharded fit+evolve step (virtual CPU mesh).

Measures the sharded step at N = 2k-16k points per
element on the 8-device mesh vs a single device, and attribute where the
REPLICATED refit becomes the bottleneck.  The evolution (trajectory moves +
branch GP queries) shards over points; the refit gathers the point set and
factorizes an (N, N) gram per element on every device -- O(N^2) memory and
O(N^3) flops replicated, so it must dominate at some N.

Runs on the virtual CPU mesh, which shows the collective structure --
all-gather for the refit, shard-local evolution -- but no device time; the
four-card comparison on real GPUs is ``python chip_smoke.py --four-cards``.

Usage: python benchmarks/bench_multichip.py [--sizes 2048,4096,8192]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate" not in flags:
    # 8 virtual-device threads timesliced on a small host spread their
    # arrivals at a collective rendezvous by the whole shard-compute time;
    # XLA:CPU's default 40 s termination killed the N=2048 run on a 1-core
    # worker (rendezvous.cc check-fail, 2026-08-20).  These only stretch the
    # stuck-detection watchdog -- they do not change the measured timings.
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=300"
              " --xla_cpu_collective_call_terminate_timeout_seconds=3000")
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as g  # noqa: E402
from gple_tpu.dynamics.evolve import evolve_step  # noqa: E402
from gple_tpu.driver import gp_dist_all  # noqa: E402
from gple_tpu.parallel.sharding import (  # noqa: E402
    density_sharding, gps_sharding, make_mesh, make_step_fn, shard_density,
    sharded_step_fn,
)
from gple_tpu.storage import fit_gp_states  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def timed(fn, args, reps):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)   # feed nothing forward: CPU backend has no result cache
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2048,4096,8192")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also append JSONL rows to this file (keep results "
                    "under benchmarks/ -- the round driver owns MULTICHIP_r*)")
    opts = ap.parse_args()
    sizes = [int(s) for s in opts.sizes.split(",")]

    results = []
    for n in sizes:
        density, gps = g._example_state(n)
        row = {"n_points": n}
        for ndev in (1, 8):
            mesh = make_mesh(ndev)
            dsh = shard_density(density, mesh)
            # evolve-only: the shard-local part
            rep = NamedSharding(mesh, P())
            ev = jax.jit(
                lambda d, s: evolve_step("SAC", 2000.0, 1.0, d, gp_dist_all, s),
                in_shardings=(density_sharding(mesh), rep), out_shardings=density_sharding(mesh),
            )
            t_ev = timed(ev, (dsh, gps), opts.reps)
            row[f"evolve_s_{ndev}dev"] = round(t_ev, 4)
            for mode, shard_refit in (("rep", False), ("shard", True)):
                if ndev == 1 and mode == "shard":
                    continue  # identical program on one device
                step = sharded_step_fn("SAC", 2000.0, 1.0, mesh,
                                       shard_refit=shard_refit)
                gin = (gps if ndev == 1 or not shard_refit
                       else jax.device_put(gps, gps_sharding(mesh)))
                t_step = timed(step, (dsh, gin), opts.reps)
                suffix = f"{ndev}dev" if ndev == 1 else f"{ndev}dev_{mode}"
                row[f"step_s_{suffix}"] = round(t_step, 4)
                row[f"refit_s_{suffix}"] = round(t_step - t_ev, 4)
        row["evolve_speedup_8dev"] = round(row["evolve_s_1dev"] / row["evolve_s_8dev"], 2)
        row["step_speedup_8dev_rep"] = round(row["step_s_1dev"] / row["step_s_8dev_rep"], 2)
        row["step_speedup_8dev_shard"] = round(row["step_s_1dev"] / row["step_s_8dev_shard"], 2)
        print(json.dumps(row), flush=True)
        if opts.out:
            with open(opts.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        results.append(row)
    return results


if __name__ == "__main__":
    main()
