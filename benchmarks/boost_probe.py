"""Per-tick channel attribution of the div-6 booster divergence (round-4
task 2).

The decompose harness (benchmarks/decompose.py, --gp off --labels carried,
n=256/div 6) holds the DIAGONALS on the exact grid and is stable at RMSE
0.0130; production diverges.  Production differs in exactly two channels:

  (a) the diagonals' own labels come from the backward-branching GP query,
      which reads the COHERENCE fit at the 3x3 branch points through the
      off-diagonal rotation (evolve.cpp:292-296 analogue,
      dynamics/evolve.py:310-318) -- a near-interpolating div-6 fit
      extrapolates noise between its samples;
  (b) cloud re-selection relabels (frozen out here via coh_reselect=False +
      track_clouds toggle, so (a) is isolated).

This probe runs the production driver tick-by-tick on the SAC crossing and,
BEFORE each step, evolves the same state twice -- once with the live GP
states and once with the coherence element masked out of the distribution --
and logs the difference of each diagonal's population numerator: the
per-tick population injected into the diagonal labels BY the coherence
channel.  Cumulative injection vs the actual population drift names the
guilty channel with numbers.

Usage: python benchmarks/boost_probe.py [--ticks 420] [-n 256] [--div 6]
       [--coh-cutoff] [--no-track] [--out file.jsonl]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from gple_tpu import observables as OBS  # noqa: E402
from gple_tpu.config import GPLEConfig  # noqa: E402
from gple_tpu.driver import GPLEDriver  # noqa: E402
from gple_tpu.dynamics import evolve as EV  # noqa: E402
from gple_tpu.storage import DIAG_INDICES, OFFDIAG_INDEX  # noqa: E402
from gple_tpu.utils.constants import purity_factor  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=420)
    ap.add_argument("-n", type=int, default=256)
    ap.add_argument("--div", type=float, default=6.0)
    ap.add_argument("--coh-extra", type=int, default=None,
                    help="booster size (default: n)")
    ap.add_argument("--coh-cutoff", action="store_true",
                    help="GPLEConfig.evolve_cutoff='coh': variance-cutoff the "
                    "coherence queries inside the evolution distribution")
    ap.add_argument("--no-track", action="store_true",
                    help="track_clouds=False (also freezes diagonal "
                    "re-selection, fully isolating channel (a))")
    ap.add_argument("--mask-coh", action="store_true",
                    help="GPLEConfig.relabel_mask_coh: mask the coherence "
                    "out of DIAGONAL relabel queries (channel (b) fix: the "
                    "(1,1) relabel integrals went corrupt-negative through "
                    "the off-diagonal rotation term)")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args()

    cfg = GPLEConfig(
        model="SAC", mass=2000.0, x0=-2.0, p0=20.0, sigma_p0=1.0,
        output_time=10.0, reopt_time=20.0, dt=1.0, num_points=opts.n,
        coh_fit_extra=opts.coh_extra if opts.coh_extra is not None else opts.n,
        coh_len_div=opts.div, coh_boost_rescale=True,
        relabel_conserve=True, coh_reselect=False,
        relabel_mask_coh=opts.mask_coh,
        track_clouds=not opts.no_track,
        evolve_cutoff="coh" if opts.coh_cutoff else False,
        fused_chunk=0,
        seed=0,
    )
    drv = GPLEDriver(cfg, verbose=True)
    drv.initialize()
    drv.observe(0, drv.opt_result.opt_type)

    from gple_tpu.driver import gp_dist_all_nocut, _evolve_dist_for

    evolve_dist = _evolve_dist_for(cfg.evolve_cutoff)

    di = np.asarray(DIAG_INDICES)
    pf = purity_factor(cfg.dim) * drv.purity_ratio
    rows = []
    cum_inject = 0.0
    pop0 = float(np.asarray(drv.density.rho)[di, :, 0].sum())
    t_start = time.time()
    for tick in range(1, opts.ticks + 1):
        probe = None
        if bool(np.asarray(drv.density.active)[OFFDIAG_INDEX]):
            # channel (a) probe: same state, coherence masked vs live
            gps_masked = drv.gps._replace(
                active=drv.gps.active.at[OFFDIAG_INDEX].set(False))
            d_live = EV.evolve_step(cfg.model, cfg.mass, cfg.dt, drv.density,
                                    evolve_dist, drv.gps)
            d_mask = EV.evolve_step(cfg.model, cfg.mass, cfg.dt, drv.density,
                                    evolve_dist, gps_masked)
            rl = np.asarray(d_live.rho)
            rm = np.asarray(d_mask.rho)
            inject = float(rl[di, :, 0].sum() - rm[di, :, 0].sum())
            cum_inject += inject
            probe = dict(
                inject=inject,
                inject_d0=float(rl[di[0], :, 0].sum() - rm[di[0], :, 0].sum()),
                inject_d1=float(rl[di[1], :, 0].sum() - rm[di[1], :, 0].sum()),
            )
        drv.step(tick)
        rho = np.asarray(drv.density.rho)
        m = np.asarray(OBS.purity_each_element(drv.density)) * pf
        row = dict(
            tick=tick,
            pop_sum=float(rho[di, :, 0].sum()),
            pop_drift=float(rho[di, :, 0].sum()) - pop0,
            cum_inject=cum_inject,
            pur_mci=float(m.sum()),
            pur_off=float(m[0, 1] + m[1, 0]),
            pur_prm=float(drv.gps.purity()),
            coh_div_eff=drv._coh_div_eff,
            coh_k=drv._coh_k,
        )
        if probe:
            row.update(probe)
        if not np.isfinite(row["pop_sum"]):
            row["diverged"] = True
            rows.append(row)
            print(json.dumps(row), flush=True)
            break
        rows.append(row)
        if tick % 10 == 0:
            print(json.dumps(row), flush=True)
    summary = dict(
        config=dict(n=opts.n, div=opts.div, coh_cutoff=opts.coh_cutoff,
                    no_track=opts.no_track, ticks=opts.ticks),
        final=rows[-1] if rows else None,
        stats=drv.stats,
        wall_s=round(time.time() - t_start, 1),
    )
    print(json.dumps(summary), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
            fh.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
