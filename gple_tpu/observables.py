"""Monte-Carlo-estimate observables over sampled phase-space points.

Replaces the reference's ``predict.cpp:65-244`` point-sum observables with
masked batched reductions.  These are the second, independent, way the program
computes population / <r> / energy / purity (the first being the analytic GP
integrals in :mod:`gple_tpu.storage`); the optimizer's ``check_averages``
compares the two (reference ``opt.cpp:1200-1270``).

Density values are RI arrays (trailing axis 2 = Re/Im, see
:mod:`gple_tpu.utils.ri`).
"""

from __future__ import annotations

import jax.numpy as jnp

from gple_tpu.models import tully
from gple_tpu.storage import DIAG_INDICES, OFFDIAG_INDEX, Density
from gple_tpu.utils import ri


def population_each_surface(density: Density) -> jnp.ndarray:
    """Normalized per-surface populations (predict.cpp:65-87)."""
    diag_idx = jnp.asarray(DIAG_INDICES)
    sums = jnp.sum(density.rho[diag_idx, :, 0], axis=1)
    sums = jnp.where(density.active[diag_idx], sums, 0.0)
    return sums / jnp.sum(sums)


def r_average_one_element(points, rho) -> jnp.ndarray:
    """<r> over one element's points, population-weighted (predict.cpp:89-107);
    0 for an element that carries no population, like the analytic <r>."""
    w = rho[..., 0]
    total = jnp.sum(w)
    empty = total == 0.0
    return jnp.where(empty, 0.0, (points.T @ w) / jnp.where(empty, 1.0, total))


def standard_deviation_one_element(points) -> jnp.ndarray:
    """Per-dimension std dev of the point cloud (predict.cpp:109-126)."""
    mean = jnp.mean(points, axis=0)
    mean_sq = jnp.mean(points**2, axis=0)
    return jnp.sqrt(jnp.maximum(mean_sq - mean**2, 0.0))


def r_average_all_surfaces(density: Density) -> jnp.ndarray:
    diag_idx = jnp.asarray(DIAG_INDICES)
    w = density.rho[diag_idx, :, 0]
    w = jnp.where(density.active[diag_idx][:, None], w, 0.0)
    num = jnp.einsum("end,en->d", density.points[diag_idx], w)
    return num / jnp.sum(w)


def total_energy_each_surface(model: str, density: Density, mass) -> jnp.ndarray:
    """Population-weighted mean total energy per surface (predict.cpp:157-190)."""
    out = []
    for s, k in enumerate(DIAG_INDICES):
        pts, rho = density.points[k], density.rho[k]
        x, p = pts[:, 0], pts[:, 1]
        e = p**2 / (2.0 * mass) + tully.adiabatic_potential(model, x)[:, s]
        w = rho[:, 0]
        out.append(jnp.sum(e * w) / jnp.sum(w))
    energies = jnp.stack(out)
    return jnp.where(density.active[jnp.asarray(DIAG_INDICES)], energies, 0.0)


def total_energy_all_surfaces(model: str, density: Density, mass) -> jnp.ndarray:
    """Single population-weighted energy over all surfaces (predict.cpp:192-220)."""
    num, den = 0.0, 0.0
    for s, k in enumerate(DIAG_INDICES):
        pts, rho = density.points[k], density.rho[k]
        x, p = pts[:, 0], pts[:, 1]
        e = p**2 / (2.0 * mass) + tully.adiabatic_potential(model, x)[:, s]
        w = jnp.where(density.active[k], rho[:, 0], 0.0)
        num = num + jnp.sum(e * w)
        den = den + jnp.sum(w)
    return num / den


def observe_all(model: str, density: Density, gps, mass):
    """Every per-output-tick observable in ONE device dispatch.

    ``GPLEDriver.observe`` previously issued ~9 separate jitted reductions
    per output tick, each with its own host round-trip.  Fusing them into
    one jit makes the output phase one round-trip per frame.  Covers the
    same quantities the reference writes per output (output.cpp:41-118).
    """
    energies = total_energy_each_surface(model, density, mass)
    return dict(
        energies=energies,
        ppl_mci=population_each_surface(density),
        ppl_prm_each=gps.population_each(),
        pop_prm=gps.population(),
        energy_prm=gps.total_energy(energies),
        energy_mci=total_energy_all_surfaces(model, density, mass),
        purity_prm=gps.purity(),
        purity_mci_raw=jnp.sum(purity_each_element(density)),
        x_average=r_average_one_element(density.points[0], density.rho[0])[0],
    )


def purity_each_element(density: Density) -> jnp.ndarray:
    """Sum |rho|^2 per element, as a (2, 2) matrix with the off-diagonal value
    mirrored (predict.cpp:222-244); ``.sum()`` of this matrix therefore counts
    the off-diagonal twice like the reference."""
    sums = jnp.sum(ri.abs2(density.rho), axis=1)
    sums = jnp.where(density.active, sums, 0.0)
    return jnp.asarray(
        [[sums[0], sums[OFFDIAG_INDEX]], [sums[OFFDIAG_INDEX], sums[2]]]
    )
