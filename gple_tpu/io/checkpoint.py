"""Checkpoint / resume for GPR-MQCLE runs.

The reference has NO restart capability: state streams to text files that
cannot be reloaded (SURVEY.md section 5).  Here the full run state --
sampled points, density values, active flags, hyperparameters, analytic
magnitudes, MC tuning state, RNG key, tick counter, and conserved targets --
round-trips through a single ``.npz`` archive (orbax is available but brings
no benefit at these sizes; the archive stays a plain, inspectable format).
"""

from __future__ import annotations

import os
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from gple_tpu.sampler.mc import MCParameters
from gple_tpu.storage import Density


def save_checkpoint(path: str, driver, tick: int) -> None:
    """Persist a :class:`gple_tpu.driver.GPLEDriver` mid-run."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    opt = driver.optimizer
    np.savez_compressed(
        path,
        tick=tick,
        key=np.asarray(driver.key),
        points=np.asarray(driver.density.points),
        rho=np.asarray(driver.density.rho),
        active=np.asarray(driver.density.active),
        extra_points=np.asarray(driver.extra.points),
        extra_rho=np.asarray(driver.extra.rho),
        diag_lengths=np.asarray(opt.diag_lengths),
        off_params=np.asarray(opt.off_params),
        diag_magnitudes=np.asarray(opt.diag_magnitudes),
        off_magnitude=opt.off_magnitude,
        total_energy=driver.total_energy,
        purity=driver.purity,
        purity_ratio=driver.purity_ratio,
        mc_steps=np.asarray([p.num_steps for p in driver.mc_params]),
        mc_displacements=np.asarray([p.displacement for p in driver.mc_params]),
        # warm-start AL multipliers from the last accepted ladder stage; a
        # (0,) sentinel means "none yet" (moment mode, or pre-first-reopt)
        al_lam=(np.asarray(opt._al_lam) if getattr(opt, "_al_lam", None)
                is not None else np.zeros((0,))),
        opt_error=float(getattr(driver.opt_result, "error", 0.0)),
        opt_type=str(getattr(driver.opt_result, "opt_type", "resumed")),
        # sticky coherence lengthscale divisor (fit-health backoff state)
        coh_div_eff=float(getattr(driver, "_coh_div_eff",
                                  driver.cfg.coh_len_div)),
        # live booster size (0 after a fit-health ejection)
        coh_k=int(getattr(driver, "_coh_k", 0)),
        # conserved total-population numerator (GPLEConfig.pop_rescale)
        pop_sum0=float(getattr(driver, "_pop_sum0", 0.0)),
    )


def load_checkpoint(path: str, driver) -> int:
    """Restore a driver saved with :func:`save_checkpoint`; returns the tick
    to resume from.  Logs a phase breakdown through ``driver._log`` -- the
    npz read, the refit dispatch (compile or executable load), and the
    observable pulls -- so a slow restore names its dominant part."""
    import time as _time

    from gple_tpu.gp.opt import Optimizer

    _t0 = _time.perf_counter()
    with np.load(path) as z:
        driver.key = jnp.asarray(z["key"])
        driver.density = Density(
            points=jnp.asarray(z["points"]),
            rho=jnp.asarray(z["rho"]),
            active=jnp.asarray(z["active"]),
        )
        driver.extra = Density(
            points=jnp.asarray(z["extra_points"]),
            rho=jnp.asarray(z["extra_rho"]),
            active=jnp.asarray(z["active"]),
        )
        driver.total_energy = float(z["total_energy"])
        driver.purity = float(z["purity"])
        driver.purity_ratio = float(z["purity_ratio"])
        driver.optimizer = Optimizer(
            model=driver.cfg.model,
            mass=driver.cfg.mass,
            total_energy=driver.total_energy,
            purity=driver.purity,
            sigma_r0=np.asarray(driver.cfg.sigma_r0),
            diag_lengths=np.asarray(z["diag_lengths"]),
            off_params=np.asarray(z["off_params"]),
            diag_magnitudes=np.asarray(z["diag_magnitudes"]),
            off_magnitude=float(z["off_magnitude"]),
            lbfgs_steps=driver.cfg.opt_steps_reopt,
            off_len_div=driver.cfg.coh_len_div,
            coh_fit_extra=driver._coh_k,
            corr_bounds=(1.0, 1.0) if driver.cfg.reference_parity
            else Optimizer.corr_bounds,
            opt_mode=driver.cfg.opt_mode,
        )
        driver.mc_params = [
            MCParameters(num_steps=int(s), displacement=float(d))
            for s, d in zip(z["mc_steps"], z["mc_displacements"])
        ]
        if "al_lam" in z and z["al_lam"].size:
            driver.optimizer._al_lam = np.asarray(z["al_lam"])
        if "coh_div_eff" in z:
            driver._coh_div_eff = float(z["coh_div_eff"])
            driver.optimizer.off_len_div = driver._coh_div_eff
        if "coh_k" in z:
            driver._coh_k = int(z["coh_k"])
            driver.optimizer.coh_fit_extra = driver._coh_k
        if "pop_sum0" in z and float(z["pop_sum0"]) != 0.0:
            driver._pop_sum0 = float(z["pop_sum0"])
        else:
            # legacy checkpoint: pin the invariant from the restored labels
            from gple_tpu.storage import DIAG_INDICES as _DI
            driver._pop_sum0 = float(
                jnp.sum(driver.density.rho[jnp.asarray(_DI)][..., 0]))
        tick = int(z["tick"])
        opt_error = float(z["opt_error"]) if "opt_error" in z else 0.0
        opt_type = str(z["opt_type"]) if "opt_type" in z else "resumed"
    _t1 = _time.perf_counter()
    driver.gps = driver._refit(driver.density)
    _t2 = _time.perf_counter()
    if driver.cfg.purity_target == "measured":
        from gple_tpu import observables as OBS
        from gple_tpu.utils.constants import purity_factor

        target = float(
            jnp.sum(OBS.purity_each_element(driver.density))
            * purity_factor(driver.cfg.dim) * driver.purity_ratio
        )
    else:
        target = driver.purity
    driver._record_fit_ref(target)
    driver.opt_result = type("R", (), {"error": opt_error, "opt_type": opt_type})()
    _t3 = _time.perf_counter()
    driver._log(f"restore phases: npz={_t1 - _t0:.1f}s refit={_t2 - _t1:.1f}s "
                f"obs={_t3 - _t2:.1f}s")
    return tick
