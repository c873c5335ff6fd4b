#!/usr/bin/env python3
"""Smoke test of gple_tpu on one NVIDIA GPU.

Drives the system's main path once through the user entry points, at the
headline width (Tully SAC, N = 1024 training points per density-matrix
element), and compares what the card computes with the CPU's f64 reference:

  a. device      -- JAX must report a GPU; prints its kind, count, name and
                    power limit.
  b. build       -- ``make -C native`` builds the fastio writer extension.
  c. main path   -- ``python -m gple_tpu.cli gple --model SAC --max-ticks 21``
                    on a reference-format input file: init (MC seeding, moment
                    optimizer, first fit), frames at ticks 0/10/20 and reopts
                    at ticks 10/20.  Checks ave.txt.
  d. step        -- the jitted fit+evolve step (``make_step_fn``) at N = 1024
                    on the card against the same step on the CPU backend.
  e. fit parity  -- analytic population / <r> / purity integrals of a card
                    fit against the CPU's f64 Cholesky fit, same cloud and
                    hyperparameters.
  f. oracles     -- ``cli se`` (absorbing) and ``cli le`` for 5 frames on the
                    card against the same commands on the CPU.

``--four-cards`` runs only the multi-device path: ``sharded_step_fn`` on a
4-card mesh at N = 4096 against the one-card step on the same state.

Every phase prints its result, wall time (compile time separately) and the
card's name and power limit.  Any failed phase makes the script exit non-zero
without the final JSON line.  It also exits non-zero, printing no result, when
JAX finds no GPU or when run outside a checkout of this repository.

Usage: python chip_smoke.py [--four-cards] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

#: phase d: normwise relative error max|gpu - cpu| / max|cpu| per output.
#: Both legs run the step in f64 (Cholesky refit, f64 predictions); they
#: differ only in summation order.  ``points`` and ``rho`` therefore agree to
#: round-off; ``alpha`` = K^-1 y carries that round-off amplified by the
#: conditioning of the N = 1024 grams (~1e7-1e8 at noise 1e-2): eps * kappa
#: ~ 1e-8, bounded here with a 100x margin.
STEP_TOL = {"points": 1e-12, "rho": 1e-12, "alpha": 1e-6}
#: phase e: the tolerances of tests/test_integral_parity.py -- 1e-3 relative
#: at the production lengthscale divisor (len_div <= 2), 1e-2 at the boosted
#: divisors, whose grams condition worse.
FIT_TOL = {2.0: 1e-3, 4.0: 1e-2, 6.0: 1e-2}
#: phase f: both legs run the oracles in f64 / c128; a different FFT and
#: summation order moves populations only at round-off.
ORACLE_TOL = 1e-10
#: phase c: physical limits on every output frame
POP_TOL = 0.01
PURITY_MAX = 1.01


def contract_line(platform: str, kind: str, count: int) -> str:
    """The last stdout line of a passing run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                               "kind": kind, "count": count}})


class Phases:
    """Runs phases, timing each and summing JAX compile time inside it."""

    def __init__(self, card: str):
        import jax

        self.card = card
        self.failed = []
        self._compile = 0.0
        #: XLA compiles: count, and seconds spent in those under 1 s (the
        #: persistent cache's min-compile-time threshold)
        self._backend = [0, 0.0]

        def listener(name, secs, **_):
            if name.startswith("/jax/core/compile/"):
                self._compile += secs
            if name == "/jax/core/compile/backend_compile_duration":
                self._backend[0] += 1
                self._backend[1] += secs if secs < 1.0 else 0.0

        jax.monitoring.register_event_duration_secs_listener(listener)

    @contextlib.contextmanager
    def run(self, name: str, result: dict):
        t0, c0 = time.perf_counter(), self._compile
        n0, small0 = self._backend
        try:
            yield
            status = "ok"
        except Exception as e:  # recorded; the run then exits non-zero
            status = "FAILED"
            result["error"] = f"{type(e).__name__}: {e}"[:1500]
            traceback.print_exc()
            self.failed.append(name)
        wall = time.perf_counter() - t0
        n_xla, small = self._backend[0] - n0, self._backend[1] - small0
        print(f"phase {name}: {status} wall_s={wall:.3f} "
              f"compile_s={self._compile - c0:.3f} xla_compiles={n_xla} "
              f"xla_compile_s_under_1s={small:.3f} card=[{self.card}] "
              f"result={json.dumps(result, default=float)}", flush=True)


def rel_err(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))), 1e-300))


def write_input(path: str, n_points: int = 1024) -> None:
    """Reference-format 8-field input file (description / value lines)."""
    fields = [("mass", 2000), ("x0", -4), ("p0", 20), ("sigma_p", 1),
              ("output time", 10), ("reoptimization time", 10), ("dt", 1),
              ("number of points", n_points)]
    with open(path, "w") as fh:
        for name, value in fields:
            fh.write(f"{name}\n{value}\n")


# -- phases -------------------------------------------------------------------

def phase_build(result):
    subprocess.run(["make", "-C", os.path.join(HERE, "native"),
                    f"PY={sys.executable}"], check=True,
                   capture_output=True, text=True)
    import numpy as np

    from gple_tpu.io import fastio

    row = fastio.format_row(np.array([1.5, -2.25e-10, 3e100]))
    back = np.frombuffer(fastio.parse_doubles(row), dtype=np.float64)
    assert list(back) == [1.5, -2.25e-10, 3e100], back
    result["extension"] = os.path.basename(fastio.__file__)


def phase_main_path(result, workdir):
    import numpy as np

    from gple_tpu import cli
    from gple_tpu.io import writers

    assert writers._fastio is not None, "fastio extension not loaded"
    inp = os.path.join(workdir, "input")
    out = os.path.join(workdir, "gple_out")
    write_input(inp)
    rc = cli.main(["gple", "--input", inp, "--outdir", out, "--model", "SAC",
                   "--max-ticks", "21", "--quiet"])
    assert rc == 0, rc
    ave = np.loadtxt(os.path.join(out, "ave.txt"), ndmin=2)
    # columns 3 and 11 are the per-surface analytic energies, which the
    # reference's ave.txt leaves unfilled (written NaN by design)
    placeholder = [3, 11]
    vals = np.delete(ave, placeholder, axis=1)
    result["frames"] = int(ave.shape[0])
    assert ave.shape == (3, 34), ave.shape
    assert np.all(np.isnan(ave[:, placeholder])), "placeholder columns moved"
    assert np.all(np.isfinite(vals)), "non-finite value in ave.txt"
    # totals: population by the analytic integrals (16) and by the MC point
    # sums (20); purity total by the analytic integrals (28).  The MC purity
    # column (33) is the reference's unnormalized point sum, not bounded by 1.
    pops = ave[:, [16, 20]]
    purity = ave[:, 28]
    result["population_dev"] = float(np.max(np.abs(pops - 1.0)))
    result["purity_max"] = float(np.max(purity))
    assert result["population_dev"] <= POP_TOL, pops
    assert result["purity_max"] <= PURITY_MAX, purity


def _step_state(n, device):
    import jax

    import __graft_entry__ as g

    with jax.default_device(device):
        return jax.device_put(g._example_state(n), device)


def phase_step(result, gpu, cpu, n=1024, steps=5):
    import jax

    from gple_tpu.parallel.sharding import make_step_fn

    step = jax.jit(make_step_fn("SAC", 2000.0, 1.0))
    state_gpu = _step_state(n, gpu)
    out_gpu = jax.block_until_ready(step(*state_gpu))
    t0 = time.perf_counter()
    nxt = out_gpu
    for _ in range(steps):
        nxt = step(*nxt)
    jax.block_until_ready(nxt)
    result["gpu_s_per_step"] = (time.perf_counter() - t0) / steps
    state_cpu = jax.device_put(state_gpu, cpu)
    out_cpu = jax.block_until_ready(step(*state_cpu))
    (d_g, s_g), (d_c, s_c) = out_gpu, out_cpu
    errs = {
        "points": rel_err(d_g.points, d_c.points),
        "rho": rel_err(d_g.rho, d_c.rho),
        "alpha": max(rel_err(s_g.diag.alpha, s_c.diag.alpha),
                     rel_err(s_g.offdiag.v, s_c.offdiag.v)),
    }
    result["rel_err"] = errs
    result["tol"] = STEP_TOL
    for k, v in errs.items():
        assert v <= STEP_TOL[k], f"{k}: {v:.3e} > {STEP_TOL[k]}"


def make_cloud(n, seed=0):
    """A coherence-bearing cloud at the SAC crossing scale: Gaussian
    positions, fringed off-diagonal labels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.normal(0.0, 0.4, n), rng.normal(20.0, 1.3, n)], axis=-1)
    env = np.exp(-0.5 * ((pts[:, 0] / 0.4) ** 2 + ((pts[:, 1] - 20.0) / 1.3) ** 2))
    off = 0.04 * env * np.exp(3.0j * pts[:, 1])
    return pts, 0.08 * env, np.stack([off.real, off.imag], axis=-1)


def _wstd(pts, w):
    import numpy as np

    w = np.maximum(np.abs(w), 1e-30)
    mu = (pts * w[:, None]).sum(0) / w.sum()
    return np.sqrt((((pts - mu) ** 2) * w[:, None]).sum(0) / w.sum())


def fit_integrals(device, cloud, len_div, block_diag):
    """Fit the real + complex kernels on ``device`` with moment-style
    hyperparameters; return the analytic integrals."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gple_tpu.ops import complex_kernels as CK
    from gple_tpu.ops import kernels as RK

    pts, y_diag, y_off = cloud
    std_d, std_o = _wstd(pts, y_diag), _wstd(pts, y_off[:, 0])
    with jax.default_device(device):
        dp = RK.KernelParams(jnp.asarray(1.0), jnp.asarray(std_d / 2.0),
                             jnp.asarray(1e-2))
        op = CK.ComplexKernelParams(
            magnitude=jnp.asarray(1.0),
            real_magnitude=jnp.asarray(float(np.sqrt(np.mean(y_off[:, 0] ** 2)))),
            real_lengths=jnp.asarray(std_o / len_div),
            imag_magnitude=jnp.asarray(float(np.sqrt(np.mean(y_off[:, 1] ** 2)))),
            imag_lengths=jnp.asarray(std_o / len_div),
            noise=jnp.asarray(1e-2), corr=jnp.asarray(0.0))
        x, yd, yo = (jnp.asarray(a) for a in (pts, y_diag, y_off))
        st = RK.fit_real(dp, x, yd)
        so = CK.fit_complex(op, x, yo, block_diag=block_diag)
        return dict(pop=float(RK.population(st)),
                    ravg=np.asarray(RK.r_average(st)).tolist(),
                    pur_diag=float(RK.purity(st)),
                    pur_off=float(CK.purity_complex(so)))


def phase_fit(result, gpu, cpu, n=1024):
    cloud = make_cloud(n)
    worst = {}
    for len_div, tol in FIT_TOL.items():
        ref = fit_integrals(cpu, cloud, len_div, False)
        variants = {
            "block_diag": fit_integrals(gpu, cloud, len_div, True),
            "full": fit_integrals(gpu, cloud, len_div, False),
        }
        for name, got in variants.items():
            for key in ref:
                e = rel_err(got[key], ref[key])
                tag = f"div{len_div:g}/{name}/{key}"
                worst[tag] = e
                assert e <= tol, f"{tag}: rel err {e:.3e} > {tol}"
    result["max_rel_err_div2"] = max(v for k, v in worst.items()
                                     if k.startswith("div2/"))
    result["max_rel_err"] = max(worst.values())
    result["tol"] = {f"len_div {k:g}": v for k, v in FIT_TOL.items()}


def _populations(outdir):
    import numpy as np

    return np.loadtxt(os.path.join(outdir, "averages.txt"), ndmin=2)[:, -2:]


def phase_oracles(result, workdir):
    from gple_tpu import cli

    inp = os.path.join(workdir, "input")
    write_input(inp)
    env = {k: v for k, v in os.environ.items()}
    env["JAX_PLATFORMS"] = "cpu"
    for cmd, extra in (("se", ["--boundary", "absorbing"]), ("le", [])):
        args = [cmd, "--input", inp, "--model", "SAC", "--max-outputs", "5",
                *extra]
        gpu_out = os.path.join(workdir, f"{cmd}_gpu")
        cpu_out = os.path.join(workdir, f"{cmd}_cpu")
        t0 = time.perf_counter()
        assert cli.main([*args, "--outdir", gpu_out]) == 0
        result[f"{cmd}_gpu_s"] = time.perf_counter() - t0
        # the CPU leg runs in a child that never opens the card
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "gple_tpu.cli", *args,
                        "--outdir", cpu_out, "--platform", "cpu"],
                       cwd=HERE, env=env, check=True, capture_output=True)
        result[f"{cmd}_cpu_s"] = time.perf_counter() - t0
        pg, pc = _populations(gpu_out), _populations(cpu_out)
        assert pg.shape == pc.shape and pg.shape[0] == 5, (pg.shape, pc.shape)
        err = float(abs(pg - pc).max())
        result[f"{cmd}_pop_max_abs_diff"] = err
        assert err <= ORACLE_TOL, f"{cmd}: {err:.3e} > {ORACLE_TOL}"
    result["tol"] = ORACLE_TOL


def phase_four_cards(result, n=4096, steps=3):
    import jax

    from gple_tpu.parallel.sharding import (
        gps_sharding, make_mesh, make_step_fn, shard_density, sharded_step_fn)

    devices = jax.devices()[:4]
    assert len(devices) == 4, f"need 4 devices, have {len(jax.devices())}"
    state = _step_state(n, devices[0])
    one = jax.jit(make_step_fn("SAC", 2000.0, 1.0))
    out_one = jax.block_until_ready(one(*state))
    t0 = time.perf_counter()
    nxt = out_one
    for _ in range(steps):
        nxt = one(*nxt)
    jax.block_until_ready(nxt)
    result["one_card_s_per_step"] = (time.perf_counter() - t0) / steps

    mesh = make_mesh(devices=devices)
    four = sharded_step_fn("SAC", 2000.0, 1.0, mesh)
    density, gps = state
    out_four = jax.block_until_ready(four(
        shard_density(density, mesh), jax.device_put(gps, gps_sharding(mesh))))
    t0 = time.perf_counter()
    nxt = out_four
    for _ in range(steps):
        nxt = four(*nxt)
    jax.block_until_ready(nxt)
    result["four_card_s_per_step"] = (time.perf_counter() - t0) / steps
    assert len(out_four[0].points.sharding.device_set) == 4
    (d4, s4), (d1, s1) = out_four, out_one
    errs = {
        "points": rel_err(d4.points, d1.points),
        "rho": rel_err(d4.rho, d1.rho),
        "alpha": max(rel_err(s4.diag.alpha, s1.diag.alpha),
                     rel_err(s4.offdiag.v, s1.offdiag.v)),
    }
    result["rel_err"] = errs
    result["tol"] = STEP_TOL
    for k, v in errs.items():
        assert v <= STEP_TOL[k], f"{k}: {v:.3e} > {STEP_TOL[k]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded step against one card")
    ap.add_argument("--workdir", default=None,
                    help="keep phase outputs here (default: a temp dir)")
    opts = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import gple_tpu
    except ImportError:
        print("chip_smoke: gple_tpu not found beside this script", file=sys.stderr)
        return 2
    if not os.path.abspath(gple_tpu.__file__).startswith(HERE + os.sep):
        print("chip_smoke: gple_tpu is not this checkout's", file=sys.stderr)
        return 2

    import jax

    jax.config.update("jax_enable_x64", True)
    from gple_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    devices = jax.devices()
    gpu = devices[0]
    if gpu.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {gpu.platform!r})",
              file=sys.stderr)
        return 1
    from bench import card_name_power

    card = card_name_power()
    print(card, flush=True)
    cpu = jax.local_devices(backend="cpu")[0]
    phases = Phases(card)
    with phases.run("a_device", {"platform": gpu.platform, "kind": gpu.device_kind,
                                 "count": len(devices)}):
        pass
    workdir = opts.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(workdir, exist_ok=True)
    if opts.four_cards:
        res = {}
        with phases.run("four_cards", res):
            phase_four_cards(res)
    else:
        for name, fn in (
            ("b_build", phase_build),
            ("c_main_path", lambda r: phase_main_path(r, workdir)),
            ("d_step", lambda r: phase_step(r, gpu, cpu)),
            ("e_fit_parity", lambda r: phase_fit(r, gpu, cpu)),
            ("f_oracles", lambda r: phase_oracles(r, workdir)),
        ):
            res = {}
            with phases.run(name, res):
                fn(res)
    if phases.failed:
        print(f"chip_smoke: FAILED phases {phases.failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    print(contract_line(gpu.platform, gpu.device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
