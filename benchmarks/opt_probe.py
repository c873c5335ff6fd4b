"""Run the test_opt scenario on the CURRENT backend and report conservation.

Discriminates backend-specific optimizer misbehavior from physics/config issues.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from gple_tpu.gp.opt import Optimizer
from gple_tpu.observables import total_energy_each_surface
from gple_tpu.sampler import mc
from gple_tpu.storage import Density, fit_gp_states

MODEL = "DAC"
MASS = 2000.0
R0 = np.array([-10.0, 30.0])
SIGMA = np.array([1.0 / 3.0, 1.5])


def dist(params, pts):
    return mc.initial_distribution(params[0], params[1], pts, 0, 0, (1.0, 0.0), (0.0, 0.0))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    print("backend:", jax.default_backend(), "N:", n, flush=True)
    key = jax.random.PRNGKey(0)
    pts0 = jnp.asarray(R0)[None, :] + jax.random.normal(key, (n, 2)) * jnp.asarray(SIGMA)
    t0 = time.time()
    pts, rho, _ = mc.element_monte_carlo(
        jax.random.PRNGKey(1), dist, (jnp.asarray(R0), jnp.asarray(SIGMA)),
        pts0, mc.MCParameters(), tune=True,
    )
    print(f"MC done in {time.time() - t0:.1f}s", flush=True)
    points = jnp.stack([pts, pts, pts])
    rho_all = jnp.stack([rho, jnp.zeros_like(rho), jnp.zeros_like(rho)])
    density = Density(points=points, rho=rho_all, active=jnp.asarray([True, False, False]))
    epts, erho = mc.generate_extra_points_element(
        jax.random.PRNGKey(2), pts, 5 * n, dist, (jnp.asarray(R0), jnp.asarray(SIGMA))
    )
    extra = Density(
        points=jnp.stack([epts] * 3),
        rho=jnp.stack([erho, jnp.zeros_like(erho), jnp.zeros_like(erho)]),
        active=density.active,
    )
    energies = total_energy_each_surface(MODEL, density, MASS)
    e0 = float(energies[0])
    optimizer = Optimizer(model=MODEL, mass=MASS, total_energy=e0, purity=1.0,
                          sigma_r0=SIGMA)
    t0 = time.time()
    result = optimizer.optimize(density, extra, energies)
    print(f"optimize done in {time.time() - t0:.1f}s type={result.opt_type} "
          f"error={result.error:.4g}", flush=True)
    dp, op = optimizer.fitted_params()
    states = fit_gp_states(dp, op, density)
    print("population:", float(states.population()))
    print("energy:", float(states.total_energy(jnp.asarray(energies))), "target", e0)
    print("purity:", float(states.purity()))
    print("diag lengths:", optimizer.diag_lengths)


if __name__ == "__main__":
    main()
