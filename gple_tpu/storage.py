"""Density-matrix point storage and GP-state containers.

Replacement for the reference's ``QuantumStorage`` triangular
container (``gaussian_process_liouville_equation/storage.h:106-329``): instead
of per-element ``std::vector``s of points with dynamic emptiness, every
lower-triangular element holds a FIXED number of points in one stacked array
and an ``active`` mask marks which elements currently carry density (the
reference's inverse ``IsSmall`` flags).  Static shapes keep the whole pipeline
jittable; inactive elements simply contribute zeros.

Complex density values are stored as trailing-axis-2 float64 RI arrays
(see :mod:`gple_tpu.utils.ri`).

Element ordering is row-major lower-triangular like the reference's loops
(``for iPES { for jPES <= iPES }``): index 0 = (0,0), 1 = (1,0), 2 = (1,1).
The off-diagonal element is index 1.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gple_tpu.ops import complex_kernels as CK
from gple_tpu.ops import kernels as RK
from gple_tpu.utils import ri

#: lower-triangular element order (row, col) for NumPES = 2
ELEMENTS = ((0, 0), (1, 0), (1, 1))
NUM_ELEMENTS = len(ELEMENTS)
DIAG_INDICES = (0, 2)     # positions of (0,0) and (1,1) in ELEMENTS
OFFDIAG_INDEX = 1         # position of (1,0)


def element_index(row: int, col: int) -> int:
    return {(0, 0): 0, (1, 0): 1, (0, 1): 1, (1, 1): 2}[(row, col)]


class Density(NamedTuple):
    """All sampled phase-space points: the reference's ``AllPoints``.

    points: (3, N, PhaseDim) coordinates per element
    rho:    (3, N, 2) RI density values at those coordinates
    active: (3,) bool -- element carries non-negligible density
    """

    points: jnp.ndarray
    rho: jnp.ndarray
    active: jnp.ndarray

    @property
    def num_points(self) -> int:
        return self.points.shape[1]

    @property
    def rho_complex(self) -> np.ndarray:
        """Host-side complex view for analysis/tests."""
        r = np.asarray(self.rho)
        return r[..., 0] + 1.0j * r[..., 1]

    @classmethod
    def from_complex(cls, points, rho_complex, active) -> "Density":
        return cls(
            points=jnp.asarray(points),
            rho=ri.from_complex(jnp.asarray(rho_complex)),
            active=jnp.asarray(active, dtype=bool),
        )

    def element(self, row: int, col: int):
        k = element_index(row, col)
        return self.points[k], self.rho[k]


def make_density(num_points: int, r0, active, dtype=jnp.float64) -> Density:
    """Seed all active elements with ``num_points`` copies of r0 (main.cpp:44-56)."""
    r0 = jnp.asarray(r0, dtype=dtype)
    pts = jnp.tile(r0[None, None, :], (NUM_ELEMENTS, num_points, 1))
    rho = jnp.zeros((NUM_ELEMENTS, num_points, 2), dtype=dtype)
    return Density(points=pts, rho=rho, active=jnp.asarray(active, dtype=bool))


class GPStates(NamedTuple):
    """Fitted GP surrogates for every element: the reference's TrainingKernels
    (``predict.h:89-143``).  ``diag`` is a batched (leading axis 2)
    RealTrainState over the two diagonal elements; ``offdiag`` the complex
    state of (1,0)."""

    diag: RK.RealTrainState
    offdiag: CK.ComplexTrainState
    active: jnp.ndarray  # (3,) same convention as Density.active

    # -- whole-matrix analytic observables (predict.cpp:395-463) --------------
    def population(self) -> jnp.ndarray:
        return jnp.sum(self.population_each())

    def population_each(self) -> jnp.ndarray:
        pops = jax.vmap(RK.population)(self.diag)
        mask = self.active[jnp.asarray(DIAG_INDICES)]
        return jnp.where(mask, pops, 0.0)

    def r_average(self) -> jnp.ndarray:
        r = jax.vmap(RK.r_average)(self.diag)
        mask = self.active[jnp.asarray(DIAG_INDICES)]
        return jnp.sum(jnp.where(mask[:, None], r, 0.0), axis=0)

    def total_energy(self, surface_energies) -> jnp.ndarray:
        """Population-weighted energies, with per-surface energies supplied by
        the MC estimate (predict.cpp:421-436)."""
        return jnp.sum(self.population_each() * surface_energies)

    def purity(self) -> jnp.ndarray:
        pur_diag = jax.vmap(RK.purity)(self.diag)
        mask = self.active[jnp.asarray(DIAG_INDICES)]
        total = jnp.sum(jnp.where(mask, pur_diag, 0.0))
        pur_off = CK.purity_complex(self.offdiag)
        return total + jnp.where(self.active[OFFDIAG_INDEX], 2.0 * pur_off, 0.0)


def fit_gp_states(
    diag_params: RK.KernelParams,
    offdiag_params: CK.ComplexKernelParams,
    density: Density,
    off_extra=None,
    block_diag: bool = False,
) -> GPStates:
    """Refactorize all element GPs from the current points (the reference
    rebuilds TrainingKernels every tick, main.cpp:176).

    ``off_extra`` = (points (K, PhaseDim), rho (K, 2)) joins the OFF-DIAGONAL
    fit only: an asymmetric point budget for the coherence, whose fit is the
    measured accuracy bottleneck (carried-label RMSE 0.0514 at N = 64 vs
    0.0073 for the diagonals, docs/DESIGN.md decomposition) while the
    diagonal fits are essentially exact at any N.  K is static, so the jitted
    shapes stay fixed.

    ``block_diag`` (STATIC): the caller guarantees the off-diagonal corr
    parameter is structurally 0 (the moment optimizer's invariant), so the
    complex fit's SPD embedding splits into two (N, N) blocks -- 4x fewer
    flops on the fit's dominant term (see CK.fit_complex).  All four SPD
    systems of the step -- the two diagonal element kernels and the two
    complex blocks -- are then inverted in one batched call (reference hot
    path kernel.cpp:281-283)."""
    from gple_tpu.ops.linalg import psd_inverse_batched

    diag_idx = jnp.asarray(DIAG_INDICES)
    diag_pts = density.points[diag_idx]
    diag_rho = density.rho[diag_idx, :, 0]
    off_pts = density.points[OFFDIAG_INDEX]
    off_rho = density.rho[OFFDIAG_INDEX]
    if off_extra is not None:
        off_pts = jnp.concatenate([off_pts, off_extra[0]], axis=0)
        off_rho = jnp.concatenate([off_rho, off_extra[1]], axis=0)

    if not block_diag:
        diag = jax.vmap(RK.fit_real)(diag_params, diag_pts, diag_rho)
        off = CK.fit_complex(offdiag_params, off_pts, off_rho)
        return GPStates(diag=diag, offdiag=off, active=density.active)

    k_d = jax.vmap(lambda p, x: RK.kernel_matrix(p, x, x, True))(
        diag_params, diag_pts
    )
    k64, kt_re64, kt_im64 = CK.covariance_matrices(
        offdiag_params, off_pts, off_pts, same=True
    )
    k_o = jnp.stack([k64 + kt_re64, k64 - kt_re64])
    if off_pts.shape[0] == diag_pts.shape[1]:
        winv = psd_inverse_batched(jnp.concatenate([k_d, k_o]))
        kinv_d, w11, w22 = winv[:2], winv[2], winv[3]
    else:
        kinv_d = psd_inverse_batched(k_d)
        winv_o = psd_inverse_batched(k_o)
        w11, w22 = winv_o[0], winv_o[1]
    diag = jax.vmap(RK.finish_real_fit)(
        diag_params, diag_pts, diag_rho, k_d, kinv_d
    )
    off = CK.finish_complex_fit(
        offdiag_params, off_pts, off_rho, k64, kt_re64, kt_im64, w11, w22
    )
    return GPStates(diag=diag, offdiag=off, active=density.active)


def predict_element(gps: GPStates, elem: int, pts, with_variance: bool = True):
    """Cutoff GP prediction for one element at ``pts`` (M, PhaseDim); zero when
    the element is inactive (main.cpp:75-101).  ``elem`` is a static index.
    Returns an RI array (M, 2)."""
    if elem == OFFDIAG_INDEX:
        _, _, cut = CK.predict_complex(gps.offdiag, pts, with_variance)
    else:
        d = 0 if elem == 0 else 1
        state = jax.tree.map(lambda a: a[d], gps.diag)
        _, _, mean_cut = RK.predict_real(state, pts, with_variance)
        cut = ri.ri(mean_cut)
    return jnp.where(gps.active[elem], cut, 0.0)


def make_distribution(gps: GPStates, with_variance: bool = True) -> Callable:
    """Batched distribution function: pts (3, M, PhaseDim) -> (3, M, 2) RI,
    one row per element.  This is the reference's ``predict_distribution``
    closure (main.cpp:75-101), vectorized over all elements at once."""

    def dist(pts_per_elem):
        return jnp.stack(
            [predict_element(gps, k, pts_per_elem[k], with_variance) for k in range(NUM_ELEMENTS)]
        )

    return dist
