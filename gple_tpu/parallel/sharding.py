"""Multi-chip data parallelism over sampled phase-space points.

The reference is a single process with shared-memory loops (SURVEY.md section
2.5); its scaling dimension is the number of sampled points N per element.
Here that axis shards across a ``jax.sharding.Mesh``:

* the evolution step (trajectory moves + the 3x3-branch GP queries) is
  embarrassingly parallel over points -- each device evolves its shard against
  a REPLICATED GP state (the training set is small, N <= a few thousand);
* the GP refit gathers the (small) point set and factorizes replicated --
  a Cholesky at N = 1024 is far below the threshold where distributing it
  would pay for its collectives;
* observables are sharded reductions; GSPMD inserts the psums.

This module provides the mesh plumbing and a sharded fit+evolve step used by
``__graft_entry__.dryrun_multichip`` and by multi-chip benchmarks.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gple_tpu.dynamics.evolve import evolve_step
from gple_tpu.driver import gp_dist_all
from gple_tpu.ops import complex_kernels as CK
from gple_tpu.ops import kernels as RK
from gple_tpu.storage import Density, GPStates, fit_gp_states

POINTS_AXIS = "points"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (POINTS_AXIS,))


def density_sharding(mesh: Mesh):
    """Shard the point axis of every Density leaf."""
    return Density(
        points=NamedSharding(mesh, P(None, POINTS_AXIS, None)),
        rho=NamedSharding(mesh, P(None, POINTS_AXIS, None)),
        active=NamedSharding(mesh, P()),
    )


def shard_density(density: Density, mesh: Mesh) -> Density:
    sh = density_sharding(mesh)
    return Density(
        points=jax.device_put(density.points, sh.points),
        rho=jax.device_put(density.rho, sh.rho),
        active=jax.device_put(density.active, sh.active),
    )


def gps_sharding(mesh: Mesh):
    """Row-shard every O(N^2)/O(N) leaf of the fitted GP states.

    Round-2 scaling measurement: with the refit REPLICATED, every device
    factorizes the full (N, N) gram, and the refit/evolve work ratio grows
    to 8.4 at N = 512 -- the replicated refit bounds scaling beyond N ~ 4k.
    Sharding the training-state rows makes the predict-time cross-gram
    contractions (k_star @ K^-1) sharded reductions; the Cholesky itself is
    placed by GSPMD."""
    def sh(*spec):
        return NamedSharding(mesh, P(*spec))

    diag = RK.RealTrainState(
        params=RK.KernelParams(magnitude=sh(), lengths=sh(), noise=sh()),
        features=sh(None, POINTS_AXIS, None),
        labels=sh(None, POINTS_AXIS),
        rescale=sh(),
        kinv=sh(None, POINTS_AXIS, None),
        alpha=sh(None, POINTS_AXIS),
    )
    off = CK.ComplexTrainState(
        params=CK.ComplexKernelParams(
            magnitude=sh(), real_magnitude=sh(), real_lengths=sh(),
            imag_magnitude=sh(), imag_lengths=sh(), noise=sh(), corr=sh(),
        ),
        features=sh(POINTS_AXIS, None),
        labels=sh(POINTS_AXIS, None),
        rescale=sh(),
        p_re=sh(POINTS_AXIS, None),
        p_im=sh(POINTS_AXIS, None),
        q_re=sh(POINTS_AXIS, None),
        q_im=sh(POINTS_AXIS, None),
        v=sh(POINTS_AXIS, None),
        chirp_k=sh(),
    )
    return GPStates(diag=diag, offdiag=off, active=sh())


def make_step_fn(model: str, mass: float, dt: float, block_diag: bool = True):
    """The flagship fit+evolve step: evolve all points one tick with the
    current GP surrogate, then refactorize the GPs from the moved points
    (the per-tick work of reference main.cpp:135-202).

    ``block_diag=True`` is the production structure: the driver's moment
    optimizer keeps the complex kernel's Re-Im correlation at 0, which
    splits the augmented solve into two (N, N) blocks (CK.fit_complex).
    Pass False to benchmark the full corr != 0 (ladder-mode) solve."""

    def step(density: Density, gps: GPStates):
        new_density = evolve_step(model, mass, dt, density, gp_dist_all, gps)
        new_gps = fit_gp_states(gps.diag.params, gps.offdiag.params, new_density,
                                block_diag=block_diag)
        return new_density, new_gps

    return step


def sharded_step_fn(model: str, mass: float, dt: float, mesh: Mesh,
                    shard_refit: bool = True):
    """jit the full step with points sharded over the mesh.

    ``shard_refit=True`` (default) also row-shards the refit OUTPUT (the
    (N, N) inverses); ``False`` keeps the GP state replicated (each device refits the full
    gram -- the round-2 behavior, kept for A/B scaling measurements)."""
    step = make_step_fn(model, mass, dt)
    dsh = density_sharding(mesh)
    gsh = gps_sharding(mesh) if shard_refit else NamedSharding(mesh, P())
    return jax.jit(
        step,
        in_shardings=(dsh, gsh),
        out_shardings=(dsh, gsh),
    )
