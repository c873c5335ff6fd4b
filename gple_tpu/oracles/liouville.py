"""Exact grid-MQCLE solver: second verification oracle.

A JAX re-design of the reference ``liouville_equation/`` subproject:
Trotter-split propagation of the partial-Wigner-transformed density matrix
rho(x, p) on a phase-space grid,

    rho(t+dt) = e^{-iL_Q dt/2} e^{-iL_R dt/2} e^{-iL_P dt} e^{-iL_R dt/2}
                e^{-iL_Q dt/2} rho(t)

Reference parity map (file:line into /root/reference):

* Trotter sandwich:                  ``liouville_equation/main.cpp:188-260``
* quantum Liouville, diabatic trick: ``liouville_equation/general.cpp:171-257``
* classical position (FFT in x):     ``liouville_equation/general.cpp:266-380``
* classical momentum (force basis):  ``liouville_equation/general.cpp:388-510``
* force basis construction:          ``liouville_equation/pes.cpp:238-347``
* grids / dt / init / stop logic:    ``liouville_equation/main.cpp:30-341``

Design notes: the density matrix is a single ``(N, N, 2, 2)``
complex array; the reference's hand-rolled ``ComplexMatrixMatrix`` container and
per-grid LAPACK/DFTI calls become batched einsums and ``jnp.fft`` along grid
axes.  Per-grid transform matrices are precomputed once with the closed-form
2x2 eigensolver.  One full Trotter step is a pure jitted function; the driver
scans it ``output_step`` times between observations.
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


@dataclasses.dataclass(frozen=True)
class LiouvilleConfig:
    model: str = "DAC"
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p: float = 1.5
    xmin: float = -10.0
    xmax: float = 10.0
    dx_input: float = 0.2
    output_time: float = 10.0
    dt_input: float = 0.1

    @property
    def sigma_x(self) -> float:
        return HBAR / (2.0 * self.sigma_p)

    @property
    def dx(self) -> float:
        p0max = self.p0 + 3.0 * self.sigma_p
        return power_of_two_cutoff(min(self.dx_input, PLANCK_H / p0max / 2.0))

    @property
    def n_grids(self) -> int:
        return int((self.xmax - self.xmin) / self.dx) + 1

    @property
    def pmin(self) -> float:
        return self.p0 - math.pi * HBAR / self.dx / 2.0

    @property
    def pmax(self) -> float:
        return self.p0 + math.pi * HBAR / self.dx / 2.0

    @property
    def dp(self) -> float:
        return (self.pmax - self.pmin) / (self.n_grids - 1)

    @property
    def x_grid(self) -> np.ndarray:
        n = self.n_grids
        i = np.arange(n)
        return (self.xmin * (n - 1 - i) + self.xmax * i) / (n - 1)

    @property
    def p_grid(self) -> np.ndarray:
        n = self.n_grids
        i = np.arange(n)
        return (self.pmin * (n - 1 - i) + self.pmax * i) / (n - 1)

    @property
    def dt(self) -> float:
        return power_of_two_cutoff(
            min(self.dt_input, HBAR / 500.0 / (self.sigma_p * self.p0 / self.mass))
        )

    @property
    def total_time(self) -> float:
        return (self.xmax - self.xmin) / (self.p0 / self.mass) * 2.0

    @property
    def output_step(self) -> int:
        return max(1, int(self.output_time / self.dt))

    @property
    def total_step(self) -> int:
        return int(self.total_time / self.dt)


def _sandwich(c, rho):
    """C^T rho C per grid point: c (N,2,2) real, rho (N,N,2,2) complex."""
    cc = c.astype(rho.dtype)
    return jnp.einsum("xba,xpbc,xcd->xpad", cc, rho, cc)


def _hermitize(rho):
    return 0.5 * (rho + jnp.conj(jnp.swapaxes(rho, -1, -2)))


class LiouvilleSolver:
    def __init__(self, cfg: LiouvilleConfig):
        self.cfg = cfg
        x = jnp.asarray(cfg.x_grid)
        p = jnp.asarray(cfg.p_grid)
        n = cfg.n_grids
        # precompute transforms and basis quantities over the x grid
        self.c_adia = tully.adiabatic_transform(cfg.model, x)        # (N,2,2)
        self.e_adia = tully.adiabatic_potential(cfg.model, x)        # (N,2)
        f_dia = tully.diabatic_force(cfg.model, x)                   # (N,2,2)
        self.f_eig, self.c_force = tully.sym2x2_eigh(f_dia)          # (N,2), (N,2,2)
        # FFT integer wavenumbers k in [0..N/2-1, -N/2..-1] (matches reference
        # general.cpp:339-346, where index k >= N/2 maps to k - N)
        self.k_wave = jnp.asarray(np.fft.fftfreq(n) * n)
        self.x = x
        self.p = p
        self._step = jax.jit(self._trotter_block, static_argnums=1)

    # -- initialization (general.cpp:68-106) -----------------------------------
    def initial_density(self) -> jnp.ndarray:
        cfg = self.cfg
        gx = jnp.exp(-(((self.x - cfg.x0) / cfg.sigma_x) ** 2) / 2.0)
        gp = jnp.exp(-(((self.p - cfg.p0) / cfg.sigma_p) ** 2) / 2.0)
        rho00 = gx[:, None] * gp[None, :] / (2.0 * math.pi * cfg.sigma_x * cfg.sigma_p)
        rho00 = rho00 / (jnp.sum(rho00) * cfg.dx * cfg.dp)
        rho = jnp.zeros((cfg.n_grids, cfg.n_grids, 2, 2), dtype=jnp.complex128)
        return rho.at[:, :, 0, 0].set(rho00)

    # -- Trotter substeps -------------------------------------------------------
    def quantum_liouville(self, rho_dia, t):
        """Diabatic-basis quantum Liouville via the adiabatic phase trick."""
        rho_adia = self.to_adiabatic(rho_dia)
        de = self.e_adia[:, 1] - self.e_adia[:, 0]  # (N,)
        ph = jnp.exp(1.0j * de * t / HBAR)          # phase for the (0,1) element
        rho_adia = rho_adia.at[:, :, 0, 1].multiply(ph[:, None])
        rho_adia = rho_adia.at[:, :, 1, 0].multiply(jnp.conj(ph)[:, None])
        return self.to_diabatic(rho_adia)

    def classical_position(self, rho, t):
        """exp(-iL_R t): FFT over x, multiply exp(-p/m * 2 pi i k / L * t)."""
        cfg = self.cfg
        length = cfg.xmax - cfg.xmin
        rho_k = jnp.fft.fft(rho, axis=0)
        phase = jnp.exp(
            -1.0j * self.p[None, :] / cfg.mass * 2.0 * math.pi * self.k_wave[:, None] / length * t
        )
        rho = jnp.fft.ifft(rho_k * phase[:, :, None, None], axis=0)
        return _hermitize(rho)

    def classical_momentum(self, rho, t):
        """exp(-iL_P t) in the force basis: FFT over p with eigen-force phases."""
        cfg = self.cfg
        length_p = cfg.pmax - cfg.pmin
        rho_f = _sandwich(self.c_force, rho)
        rho_k = jnp.fft.fft(rho_f, axis=1)
        # F_a + F_b per (x, a, b)
        f_sum = self.f_eig[:, :, None] + self.f_eig[:, None, :]  # (N,2,2)
        phase = jnp.exp(
            -1.0j
            * f_sum[:, None, :, :]
            * math.pi
            * self.k_wave[None, :, None, None]
            / length_p
            * t
        )
        rho_f = jnp.fft.ifft(rho_k * phase, axis=1)
        rho_f = _hermitize(rho_f)
        return _hermitize(_sandwich(jnp.swapaxes(self.c_force, -1, -2), rho_f))

    def trotter_step(self, rho_dia, dt):
        rho = self.quantum_liouville(rho_dia, dt / 2.0)
        rho = self.classical_position(rho, dt / 2.0)
        rho = self.classical_momentum(rho, dt)
        rho = self.classical_position(rho, dt / 2.0)
        rho = self.quantum_liouville(rho, dt / 2.0)
        return rho

    def _trotter_block(self, rho, n_steps: int):
        def body(r, _):
            return self.trotter_step(r, self.cfg.dt), None

        rho, _ = jax.lax.scan(body, rho, None, length=n_steps)
        return rho

    # -- observables (adiabatic basis; general.cpp:108-164) ---------------------
    def to_adiabatic(self, rho_dia):
        # _sandwich(M, rho) = M^T rho M, so this is C^T rho_dia C
        return _sandwich(self.c_adia, rho_dia)

    def to_diabatic(self, rho_adia):
        # C rho_adia C^T
        return _sandwich(jnp.swapaxes(self.c_adia, -1, -2), rho_adia)

    def populations(self, rho_adia):
        cfg = self.cfg
        return jnp.real(jnp.einsum("xpaa->a", rho_adia)) * cfg.dx * cfg.dp

    def averages(self, rho_adia):
        cfg = self.cfg
        ppl_grid = jnp.real(jnp.einsum("xpaa->xpa", rho_adia))  # (N,N,2)
        kin = (self.p ** 2 / (2.0 * cfg.mass))[None, :, None]
        pot = self.e_adia[:, None, :]
        e = jnp.sum(ppl_grid * (pot + kin)) * cfg.dx * cfg.dp
        x = jnp.sum(ppl_grid * self.x[:, None, None]) * cfg.dx * cfg.dp
        p = jnp.sum(ppl_grid * self.p[None, :, None]) * cfg.dx * cfg.dp
        return e, x, p

    # -- main loop (main.cpp:192-314) -------------------------------------------
    def run(self, store_rho: bool = True, max_outputs: Optional[int] = None):
        cfg = self.cfg
        n_out = cfg.total_step // cfg.output_step + 1
        if max_outputs is not None:
            n_out = min(n_out, max_outputs)
        rho_adia = self.initial_density()
        rho_dia = self.to_diabatic(rho_adia)
        times, rhos, avgs, ppls = [], [], [], []
        last_x = None
        for i_out in range(n_out):
            t = i_out * cfg.output_step * cfg.dt
            rho_adia = self.to_adiabatic(rho_dia)
            e, x, p = self.averages(rho_adia)
            ppl = self.populations(rho_adia)
            times.append(t)
            if store_rho:
                rhos.append(np.asarray(rho_adia))
            avgs.append((float(e), float(x), float(p)))
            ppls.append(np.asarray(ppl))
            x_f = float(x)
            if x_f > 0.0 and (
                (last_x is not None and (x_f - last_x) * cfg.p0 < 0) or x_f > -cfg.x0
            ):
                break
            last_x = x_f
            rho_dia = self._step(rho_dia, cfg.output_step)
        return LiouvilleResult(
            cfg=cfg,
            times=np.asarray(times),
            rhos=np.asarray(rhos) if store_rho else None,
            averages=np.asarray(avgs),
            populations=np.asarray(ppls),
        )


@dataclasses.dataclass
class LiouvilleResult:
    cfg: LiouvilleConfig
    times: np.ndarray
    rhos: Optional[np.ndarray]      # (n_out, N, N, 2, 2) adiabatic
    averages: np.ndarray            # (n_out, 3)
    populations: np.ndarray         # (n_out, 2)

    def save_txt(self, outdir: str) -> None:
        """Emit x.txt p.txt t.txt phase.txt averages.txt (reference formats)."""
        import os

        os.makedirs(outdir, exist_ok=True)
        np.savetxt(os.path.join(outdir, "x.txt"), self.cfg.x_grid)
        np.savetxt(os.path.join(outdir, "p.txt"), self.cfg.p_grid)
        np.savetxt(os.path.join(outdir, "t.txt"), self.times)
        with open(os.path.join(outdir, "averages.txt"), "w") as f:
            for t, (e, x, p), ppl in zip(self.times, self.averages, self.populations):
                f.write(f"{t} {e} {x} {p} " + " ".join(str(v) for v in ppl) + "\n")
        if self.rhos is not None:
            with open(os.path.join(outdir, "phase.txt"), "w") as f:
                for frame in self.rhos:
                    vals = frame.transpose(2, 3, 0, 1).reshape(4, -1)
                    for row in vals:
                        f.write(
                            " ".join(f"{v.real:.18g} {v.imag:.18g}" for v in row) + "\n"
                        )
                    f.write("\n")
