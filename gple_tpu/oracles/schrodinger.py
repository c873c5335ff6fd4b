"""Exact DVR Schroedinger solver: the primary verification oracle.

A JAX re-design of the reference ``schrodinger_equation/`` subproject:
Colbert-Miller discrete variable representation with reflective, periodic, or
Manolopoulos-absorbing boundaries, spectral or RK4 propagation, and a
matmul-formulated Wigner transform.

Reference parity map (file:line into /root/reference):

* kinetic-energy DVR blocks, 3 boundary types: ``schrodinger_equation/general.cpp:115-202``
* spectral propagator (no ABC) and RK4 (ABC):  ``schrodinger_equation/general.cpp:204-277``
* Gaussian wavepacket init + normalization:    ``schrodinger_equation/general.cpp:75-104``
* Wigner transform w/ boundary-aware limits:   ``schrodinger_equation/general.cpp:324-411``
* <E>, <x>, <p> via H and FD momentum matrix:  ``schrodinger_equation/general.cpp:443-478``
* driver grid/dt/stop logic:                   ``schrodinger_equation/main.cpp:41-323``

Design notes:

* The Hamiltonian is built once as dense ``(2N, 2N)`` arrays from broadcasted
  index grids -- no loops.
* The Wigner transform is one ``(4N, 2N-1) @ (2N-1, N)`` complex matmul per
  frame instead of the reference's triple loop: with ``F[x, k] =
  psi_i(x-k) conj(psi_j(x+k)) mask(x, k)`` and ``E[k, p] = exp(2 i p k dx)``,
  ``W = F @ E * dx / (pi hbar)``.
* Time stepping: spectral propagation evaluates ``C exp(-i E t) C^H psi0`` at
  arbitrary t; the absorbing path runs RK4 micro-steps under ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from gple_tpu.models import tully
from gple_tpu.utils.constants import HBAR, PLANCK_H, power_of_two_cutoff

BOUNDARIES = ("reflective", "periodic", "absorbing")

#: stop-condition constants (reference ``schrodinger_equation/general.h:45-46``)
PPL_LIM = 1e-4
CHANGE_LIM = 1e-5


@dataclasses.dataclass(frozen=True)
class DVRConfig:
    model: str = "DAC"
    boundary: str = "absorbing"
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p: float = 1.5
    xmin: float = -10.0
    xmax: float = 10.0
    dx_input: float = 0.1
    output_time: float = 10.0
    dt_input: float = 0.01

    def __post_init__(self):
        if self.boundary not in BOUNDARIES:
            raise ValueError(f"boundary must be one of {BOUNDARIES}")

    # -- derived grid quantities (reference main.cpp:63-146) ------------------
    @property
    def sigma_x(self) -> float:
        return HBAR / (2.0 * self.sigma_p)

    @property
    def dx(self) -> float:
        p0max = self.p0 + 3.0 * self.sigma_p
        return power_of_two_cutoff(min(self.dx_input, PLANCK_H / p0max / 5.0))

    @property
    def absorbing_length(self) -> float:
        if self.boundary != "absorbing":
            return 0.0
        p0min = self.p0 - 3.0 * self.sigma_p
        return PLANCK_H / p0min

    @property
    def n_interacting(self) -> int:
        return int((self.xmax - self.xmin) / self.dx) + 1

    @property
    def n_absorbing(self) -> int:
        return int(self.absorbing_length / self.dx)

    @property
    def n_grids(self) -> int:
        return self.n_interacting + 2 * self.n_absorbing

    @property
    def x_grid(self) -> np.ndarray:
        i = np.arange(self.n_grids)
        return self.xmin + self.dx * (i - self.n_absorbing)

    @property
    def p_grid(self) -> np.ndarray:
        n = self.n_grids
        pmin = self.p0 - math.pi * HBAR / self.dx / 2.0
        pmax = self.p0 + math.pi * HBAR / self.dx / 2.0
        i = np.arange(n)
        return ((n - 1 - i) * pmin + i * pmax) / (n - 1)

    @property
    def dt(self) -> float:
        if self.boundary == "absorbing":
            return power_of_two_cutoff(
                min(self.dt_input, HBAR / 500.0 / (self.sigma_p * self.p0 / self.mass))
            )
        return self.output_time

    @property
    def total_time(self) -> float:
        return (self.xmax - self.xmin) / (self.p0 / self.mass) * 2.0

    @property
    def output_step(self) -> int:
        return max(1, int(self.output_time / self.dt))

    @property
    def total_step(self) -> int:
        return int(self.total_time / self.dt)


def kinetic_matrix(n: int, dx: float, mass: float, boundary: str) -> jnp.ndarray:
    """Colbert-Miller kinetic-energy DVR block T (n, n), real symmetric."""
    i = jnp.arange(n)
    d = i[:, None] - i[None, :]
    if boundary in ("reflective", "absorbing"):
        off = jnp.where(d == 0, 1, d).astype(jnp.float64)
        t_off = ((-1.0) ** d) * (HBAR / dx) ** 2 / (off * off) / mass
        t_diag = (math.pi * HBAR / dx) ** 2 / 6.0 / mass
        return jnp.where(d == 0, t_diag, t_off)
    # periodic
    length = (n - 1) * dx
    ang = d * math.pi / n
    sin2 = jnp.where(d == 0, 1.0, jnp.sin(ang) ** 2)
    t_off = ((-1.0) ** d) * jnp.cos(ang) * (math.pi * HBAR / length) ** 2 / sin2 / mass
    t_diag = (math.pi * HBAR / length) ** 2 / 6.0 / mass * (n * n - 1)
    return jnp.where(d == 0, t_diag, t_off)


def hamiltonian(cfg: DVRConfig, include_absorbing: bool = True) -> jnp.ndarray:
    """Dense diabatic Hamiltonian, shape ``(2N, 2N)`` complex, surface-major."""
    n = cfg.n_grids
    x = jnp.asarray(cfg.x_grid)
    v = tully.diabatic_potential(cfg.model, x)  # (n, 2, 2)
    t_block = kinetic_matrix(n, cfg.dx, cfg.mass, cfg.boundary)
    # H[(m, i), (mm, j)] = T_ij delta_mmm + V_mmm(x_i) delta_ij [- i A(x_i) delta]
    eye_n = jnp.eye(n)
    eye_2 = jnp.eye(2)
    # potential couples surfaces at the same grid point: V_{m,mm}(x_i) delta_ij
    h = jnp.einsum("imk,ij->mikj", v.astype(jnp.complex128), eye_n)
    # kinetic couples grids on the same surface: T_ij delta_{m,mm}
    h = h + jnp.einsum("ij,mk->mikj", t_block.astype(jnp.complex128), eye_2)
    if cfg.boundary == "absorbing" and include_absorbing:
        a = tully.absorbing_potential(cfg.mass, cfg.xmin, cfg.xmax, cfg.absorbing_length, x)
        h = h - 1.0j * jnp.einsum("i,ij,mk->mikj", a, eye_n, eye_2)
    return h.reshape(2 * n, 2 * n)


def initial_wavefunction(cfg: DVRConfig) -> jnp.ndarray:
    """Gaussian wavepacket on the ground adiabatic surface, grid-normalized."""
    x = jnp.asarray(cfg.x_grid)
    psi0 = jnp.exp(
        -(((x - cfg.x0) / (2.0 * cfg.sigma_x)) ** 2) + 1.0j * cfg.p0 * x / HBAR
    ) / math.sqrt(math.sqrt(2.0 * math.pi) * cfg.sigma_x)
    psi = jnp.concatenate([psi0, jnp.zeros_like(psi0)])
    norm = jnp.sqrt(jnp.sum(jnp.abs(psi) ** 2) * cfg.dx)
    return psi / norm


def adiabatic_to_diabatic_matrix(cfg: DVRConfig) -> jnp.ndarray:
    """Block-diagonal transform psi_dia = C psi_adia over the grid, (2N, 2N)."""
    c = tully.adiabatic_transform(cfg.model, jnp.asarray(cfg.x_grid))  # (n, 2, 2)
    n = cfg.n_grids
    big = jnp.zeros((2, n, 2, n), dtype=jnp.complex128)
    big = big + jnp.einsum("imk,ij->mikj", c.astype(jnp.complex128), jnp.eye(n))
    return big.reshape(2 * n, 2 * n)


def wigner_transform(psi: jnp.ndarray, x_grid, p_grid, dx: float, boundary: str):
    """Wigner transform of all 4 density-matrix elements, shape ``(2, 2, N, N)``.

    W_ij(x, p) = sum_y exp(2 i p y / hbar) psi_i(x - y) conj(psi_j(x + y))
                 * dx / (pi hbar)
    formulated as one complex matmul per element pair.
    """
    n = x_grid.shape[0]
    psi2 = psi.reshape(2, n)
    k = jnp.arange(-(n - 1), n)  # (2n-1,) offsets
    xi = jnp.arange(n)
    im = xi[:, None] - k[None, :]  # x - y index
    ip = xi[:, None] + k[None, :]  # x + y index
    if boundary == "periodic":
        mask = jnp.abs(k)[None, :] <= n // 3
        im_w = jnp.mod(im, n)
        ip_w = jnp.mod(ip, n)
    else:
        mask = (im >= 0) & (im < n) & (ip >= 0) & (ip < n)
        im_w = jnp.clip(im, 0, n - 1)
        ip_w = jnp.clip(ip, 0, n - 1)
    phases = jnp.exp(2.0j * jnp.asarray(p_grid)[None, :] * (k * dx)[:, None] / HBAR)
    out = []
    for i in range(2):
        fvals_i = psi2[i][im_w]
        for j in range(2):
            f = fvals_i * jnp.conj(psi2[j][ip_w]) * mask  # (n, 2n-1)
            w = f @ phases  # (n_x, n_p)
            out.append(w)
    return jnp.stack(out).reshape(2, 2, n, n) * (dx / (math.pi * HBAR))


def fd_derivative_matrix(n: int, dx: float) -> jnp.ndarray:
    """Infinite-order finite-difference first-derivative matrix (n, n)."""
    i = jnp.arange(n)
    d = i[:, None] - i[None, :]
    off = jnp.where(d == 0, 1, d).astype(jnp.float64)
    return jnp.where(d == 0, 0.0, ((-1.0) ** d) / (dx * off))


class DVRSolver:
    """Builds the operators once, then propagates and observes.

    Usage::

        solver = DVRSolver(DVRConfig(model="SAC", p0=20.0))
        result = solver.run()
    """

    def __init__(self, cfg: DVRConfig):
        self.cfg = cfg
        n = cfg.n_grids
        self.h = hamiltonian(cfg)
        self.h_hermitian = hamiltonian(cfg, include_absorbing=False)
        self.transform = adiabatic_to_diabatic_matrix(cfg)
        self.psi0_adia = initial_wavefunction(cfg)
        self.psi0_dia = self.transform @ self.psi0_adia
        deriv = fd_derivative_matrix(n, cfg.dx)
        zero = jnp.zeros_like(deriv)
        self.p_op = -1.0j * HBAR * jnp.block([[deriv, zero], [zero, deriv]])
        if cfg.boundary != "absorbing":
            # Hermitian: one-time spectral decomposition (general.cpp:204-227)
            eigval, eigvec = jnp.linalg.eigh(self.h)
            self._eigval = eigval
            self._eigvec = eigvec
            self._coef0 = eigvec.conj().T @ self.psi0_dia
            self._evolve_to = jax.jit(self._spectral_evolve)
        else:
            # Strang splitting: exp(-iH dt) ~ D exp(-iH_herm dt) D with
            # D = exp(-A dt / 2).  Unconditionally stable (the reference's RK4,
            # general.cpp:253-277, diverges when a grid point falls close to
            # the Manolopoulos singularity at the absorber edge) and spectrally
            # exact for the Hermitian part.  RK4 remains available for parity.
            eigval, eigvec = jnp.linalg.eigh(self.h_hermitian)
            self._eigval = eigval
            self._eigvec = eigvec
            a = tully.absorbing_potential(
                cfg.mass, cfg.xmin, cfg.xmax, cfg.absorbing_length, jnp.asarray(cfg.x_grid)
            )
            self._half_decay = jnp.exp(-jnp.tile(a, 2) * cfg.dt / (2.0 * HBAR))
            self._phase_dt = jnp.exp(-1.0j * eigval * cfg.dt / HBAR)
            self._rk4_block = jax.jit(self._rk4_steps, static_argnums=1)
            self._strang_block = jax.jit(self._strang_steps, static_argnums=1)

    # -- propagation ----------------------------------------------------------
    def _spectral_evolve(self, t):
        phase = jnp.exp(-1.0j * self._eigval * t / HBAR)
        return self._eigvec @ (phase * self._coef0)

    def _rk4_steps(self, psi, n_steps: int):
        dt = self.cfg.dt
        h = self.h

        def one_step(psi, _):
            k1 = h @ psi / (1.0j * HBAR)
            k2 = h @ (psi + dt / 2.0 * k1) / (1.0j * HBAR)
            k3 = h @ (psi + dt / 2.0 * k2) / (1.0j * HBAR)
            k4 = h @ (psi + dt * k3) / (1.0j * HBAR)
            return psi + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4), None

        psi, _ = jax.lax.scan(one_step, psi, None, length=n_steps)
        return psi

    def _strang_steps(self, psi, n_steps: int):
        v, vh = self._eigvec, self._eigvec.conj().T
        d, ph = self._half_decay, self._phase_dt

        def one_step(psi, _):
            psi = d * psi
            psi = v @ (ph * (vh @ psi))
            return d * psi, None

        psi, _ = jax.lax.scan(one_step, psi, None, length=n_steps)
        return psi

    # -- observables ----------------------------------------------------------
    def averages(self, psi_dia):
        """<E>, <x>, <p> from the diabatic wavefunction (general.cpp:443-478)."""
        cfg = self.cfg
        n = cfg.n_grids
        e = jnp.real(jnp.vdot(psi_dia, self.h_hermitian @ psi_dia)) * cfg.dx
        dens = jnp.abs(psi_dia.reshape(2, n)) ** 2
        x = jnp.sum(dens * jnp.asarray(cfg.x_grid)[None, :]) * cfg.dx
        p = jnp.real(jnp.vdot(psi_dia, self.p_op @ psi_dia)) * cfg.dx
        return e, x, p

    def populations(self, psi_adia):
        n = self.cfg.n_grids
        dens = jnp.abs(psi_adia.reshape(2, n)) ** 2
        return jnp.sum(dens, axis=1) * self.cfg.dx

    # -- main loop (reference main.cpp:211-298) --------------------------------
    def run(self, store_wigner: bool = True, max_outputs: Optional[int] = None):
        cfg = self.cfg
        n_out = cfg.total_step // cfg.output_step + 1
        if max_outputs is not None:
            n_out = min(n_out, max_outputs)
        times, psis, wigners, avgs, ppls = [], [], [], [], []
        psi_dia = self.psi0_dia
        transform_h = self.transform.conj().T
        last_x, last_ppl = None, None
        for i_out in range(n_out):
            t = i_out * cfg.output_step * cfg.dt
            psi_adia = transform_h @ psi_dia
            e, x, p = self.averages(psi_dia)
            ppl = self.populations(psi_adia)
            times.append(t)
            psis.append(np.asarray(psi_adia))
            if store_wigner:
                wigners.append(
                    np.asarray(
                        wigner_transform(psi_adia, cfg.x_grid, cfg.p_grid, cfg.dx, cfg.boundary)
                    )
                )
            avgs.append((float(e), float(x), float(p)))
            ppls.append(np.asarray(ppl))
            # stop conditions (main.cpp:255-287)
            x_f = float(x)
            if x_f > 0.0:
                if x_f > -cfg.x0:
                    break
                if last_x is not None and (x_f - last_x) * cfg.p0 < 0:
                    break
                if cfg.boundary == "absorbing" and float(jnp.sum(ppl)) < PPL_LIM:
                    break
                if last_ppl is not None and np.all(np.abs(np.asarray(ppl) - last_ppl) < CHANGE_LIM):
                    break
            last_x, last_ppl = x_f, np.asarray(ppl)
            # propagate to the next output time
            if cfg.boundary == "absorbing":
                psi_dia = self._strang_block(psi_dia, cfg.output_step)
            else:
                psi_dia = self._evolve_to((i_out + 1) * cfg.output_step * cfg.dt)
        return DVRResult(
            cfg=cfg,
            times=np.asarray(times),
            psis=np.asarray(psis),
            wigners=np.asarray(wigners) if store_wigner else None,
            averages=np.asarray(avgs),
            populations=np.asarray(ppls),
        )


@dataclasses.dataclass
class DVRResult:
    cfg: DVRConfig
    times: np.ndarray
    psis: np.ndarray
    wigners: Optional[np.ndarray]
    averages: np.ndarray      # (n_out, 3): <E>, <x>, <p>
    populations: np.ndarray   # (n_out, 2)

    def save_txt(self, outdir: str) -> None:
        """Emit the reference's output files (x.txt p.txt t.txt psi.txt
        phase.txt averages.txt) so its plot scripts work unchanged."""
        import os

        os.makedirs(outdir, exist_ok=True)
        np.savetxt(os.path.join(outdir, "x.txt"), self.cfg.x_grid)
        np.savetxt(os.path.join(outdir, "p.txt"), self.cfg.p_grid)
        np.savetxt(os.path.join(outdir, "t.txt"), self.times)
        with open(os.path.join(outdir, "psi.txt"), "w") as f:
            for psi in self.psis:
                f.write(" ".join(f"{abs(v) ** 2:.18g}" for v in psi) + "\n")
        with open(os.path.join(outdir, "averages.txt"), "w") as f:
            for t, (e, x, p), ppl in zip(self.times, self.averages, self.populations):
                f.write(f"{t} {e} {x} {p} " + " ".join(str(v) for v in ppl) + "\n")
        if self.wigners is not None:
            with open(os.path.join(outdir, "phase.txt"), "w") as f:
                for frame in self.wigners:
                    for i in range(2):
                        for j in range(2):
                            vals = frame[i, j].ravel()
                            f.write(
                                " "
                                + " ".join(f"{v.real:.18g} {v.imag:.18g}" for v in vals)
                                + "\n"
                            )
                    f.write("\n")
