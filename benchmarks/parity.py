"""Physics parity: GPR-MQCLE populations vs the exact DVR solution.

The BASELINE.json north-star: on Tully model A, the full GPR-MQCLE trajectory
must reproduce the exact (DVR) populations to RMSE < 1e-3 on one chip in
under 5 minutes.  This script runs both solvers on a matching configuration
and reports the RMSE and wall times as one JSON line.

Usage:
    python benchmarks/parity.py [--model SAC] [--p0 P0] [--x0 X0] [-n N]
                                [--dt DT] [--platform cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="SAC")
    ap.add_argument("--p0", type=float, default=20.0)
    ap.add_argument("--x0", type=float, default=-4.0)
    ap.add_argument("--sigma-p", type=float, default=1.0)
    ap.add_argument("-n", type=int, default=128, help="GPLE points per element")
    ap.add_argument("--dt", type=float, default=1.0)
    ap.add_argument("--reopt-time", type=float, default=10.0)
    ap.add_argument("--output-time", type=float, default=10.0)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--max-ticks", type=int, default=None)
    ap.add_argument("--opt-mode", default=None, choices=["moment", "ladder"],
                    help="override GPLEConfig.opt_mode for A/B parity runs")
    ap.add_argument("--moment-per-tick", default=None, choices=["0", "1", "off"],
                    help="override GPLEConfig.moment_per_tick "
                    "(off = track only the coherence lengths per tick)")
    ap.add_argument("--coh-extra", type=int, default=None,
                    help="GPLEConfig.coh_fit_extra (coherence fit boost)")
    ap.add_argument("--coh-len-div", type=float, default=None,
                    help="GPLEConfig.coh_len_div (coherence lengthscale divisor)")
    ap.add_argument("--mc-retune", default=None, choices=["true", "false", "auto"],
                    help="GPLEConfig.mc_retune (auto = acceptance-gated)")
    ap.add_argument("--walk-surrogate", type=int, default=None, choices=[0, 1],
                    help="GPLEConfig.mc_walk_surrogate (grid walk target)")
    ap.add_argument("--track-clouds", type=int, default=None, choices=[0, 1],
                    help="GPLEConfig.track_clouds (drift re-selection)")
    ap.add_argument("--coh-rescale", type=int, default=None, choices=[0, 1],
                    help="GPLEConfig.coh_boost_rescale (purity clamp)")
    ap.add_argument("--init-cache", type=int, default=None, choices=[0, 1],
                    help="GPLEConfig.init_cache (restore the deterministic "
                    "init state on repeat runs of the same config)")
    ap.add_argument("--relabel-conserve", type=int, default=None,
                    choices=[0, 1], help="GPLEConfig.relabel_conserve")
    ap.add_argument("--relabel-mask-coh", type=int, default=None,
                    choices=[0, 1], help="GPLEConfig.relabel_mask_coh")
    ap.add_argument("--coh-reselect", type=int, default=None, choices=[0, 1],
                    help="GPLEConfig.coh_reselect (0 freezes the boosted "
                    "coherence cloud out of drift re-selection)")
    ap.add_argument("--evolve-cutoff", default=None, choices=["0", "1", "coh"],
                    help="GPLEConfig.evolve_cutoff (coh = variance-cutoff "
                    "only the coherence's evolution queries)")
    opts = ap.parse_args()

    import jax

    if opts.platform:
        jax.config.update("jax_platforms", opts.platform)
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from gple_tpu.config import GPLEConfig
    from gple_tpu.driver import GPLEDriver
    from gple_tpu.oracles.schrodinger import DVRConfig, DVRSolver

    cfg = GPLEConfig(
        model=opts.model, mass=2000.0, x0=opts.x0, p0=opts.p0,
        sigma_p0=opts.sigma_p, output_time=opts.output_time,
        reopt_time=opts.reopt_time, dt=opts.dt, num_points=opts.n,
        **({"opt_mode": opts.opt_mode} if opts.opt_mode else {}),
        **({"moment_per_tick": {"0": False, "1": True, "off": "off"}[opts.moment_per_tick]}
           if opts.moment_per_tick is not None else {}),
        **({"coh_fit_extra": opts.coh_extra} if opts.coh_extra is not None else {}),
        **({"coh_len_div": opts.coh_len_div}
           if opts.coh_len_div is not None else {}),
        **({"mc_retune": {"true": True, "false": False, "auto": "auto"}[opts.mc_retune]}
           if opts.mc_retune is not None else {}),
        **({"track_clouds": bool(opts.track_clouds)}
           if opts.track_clouds is not None else {}),
        **({"mc_walk_surrogate": bool(opts.walk_surrogate)}
           if opts.walk_surrogate is not None else {}),
        **({"coh_boost_rescale": bool(opts.coh_rescale)}
           if opts.coh_rescale is not None else {}),
        **({"init_cache": bool(opts.init_cache)}
           if opts.init_cache is not None else {}),
        **({"relabel_conserve": bool(opts.relabel_conserve)}
           if opts.relabel_conserve is not None else {}),
        **({"relabel_mask_coh": bool(opts.relabel_mask_coh)}
           if opts.relabel_mask_coh is not None else {}),
        **({"coh_reselect": bool(opts.coh_reselect)}
           if opts.coh_reselect is not None else {}),
        **({"evolve_cutoff": {"0": False, "1": True, "coh": "coh"}[opts.evolve_cutoff]}
           if opts.evolve_cutoff is not None else {}),
    )
    # exact oracle on the same physics, interaction region +-2|x0|
    se_cfg = DVRConfig(
        model=opts.model, boundary="reflective", mass=cfg.mass, x0=cfg.x0,
        p0=cfg.p0, sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
        dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt,
    )
    t0 = time.time()
    se = DVRSolver(se_cfg).run(store_wigner=False)
    t_se = time.time() - t0
    print(f"# DVR: {len(se.times)} frames in {t_se:.1f}s", file=sys.stderr)

    t0 = time.time()
    drv = GPLEDriver(cfg, verbose=True)
    hist = drv.run(max_ticks=opts.max_ticks)
    t_gple = time.time() - t0

    # align by time and compare ground-state populations, by BOTH estimators
    # the reference writes to ave.txt (output.cpp:41-118): the normalized MC
    # sum over sampled points and the analytic parameter integral of the GP
    gple_t = np.array([r.time for r in hist])
    gple_p0 = np.array([r.population_mci[0] for r in hist])
    gple_p0_prm = np.array([r.population_prm_each[0] for r in hist])
    se_p0 = np.interp(gple_t, se.times, se.populations[:, 0])
    # side="right": frames strictly past the DVR horizon would interp-clamp
    # to the last DVR value and bias the RMSE (a round-3 review)
    n_cmp = min(len(gple_t),
                int(np.searchsorted(gple_t, se.times[-1], side="right")))
    rmse = float(np.sqrt(np.mean((gple_p0[:n_cmp] - se_p0[:n_cmp]) ** 2)))
    rmse_prm = float(np.sqrt(np.mean((gple_p0_prm[:n_cmp] - se_p0[:n_cmp]) ** 2)))

    def _num(x):
        # a diverged run's RMSE must serialize as null, not an astronomical
        # float (artifact hygiene)
        return round(x, 6) if np.isfinite(x) and abs(x) < 1e6 else None

    print(
        json.dumps(
            {
                # headline policy (fixed ex ante): the MC
                # estimator is always "value"; prm stays a secondary field
                "metric": f"Tully-{opts.model} population RMSE vs DVR (mci)",
                "value": _num(rmse),
                "unit": "population",
                "rmse_mci": _num(rmse),
                "rmse_prm": _num(rmse_prm),
                "gple_wall_s": round(t_gple, 1),
                "dvr_wall_s": round(t_se, 1),
                "frames_compared": int(n_cmp),
                "target": 1e-3,
                "phase_times": {k: round(v, 1) for k, v in drv.phase_times.items()},
                "stats": drv.stats,
                "platform": jax.default_backend(),
            }
        )
    )


if __name__ == "__main__":
    main()
