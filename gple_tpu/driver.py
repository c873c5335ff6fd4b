"""The GPR-MQCLE driver: fit -> sample -> evolve -> refit.

Re-design of the reference main loop
(``gaussian_process_liouville_equation/main.cpp:19-212``):

1. seed N points per populated element at r0, Metropolis-select them from the
   initial Gaussian distribution (main.cpp:44-57)
2. record the conserved targets: total energy, purity = 1 (main.cpp:59-66)
3. jitter 5N extra points per element for fitting (main.cpp:69)
4. optimize hyperparameters under the conservation constraints (main.cpp:71-73)
5. per tick: evolve density AND extra points with the branching evolver, check
   element appearance/disappearance, re-optimize on schedule / on element
   change / on conservation drift, otherwise just refactorize the GP states
   from the moved points (main.cpp:135-202)
6. stop once <x> passes -x0 (main.cpp:195-200)

Everything inside a tick is jitted with static shapes; Python only decides
WHEN to re-optimize (mirroring the reference's control flow, which is also
host-side).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gple_tpu import observables as OBS
from gple_tpu.config import GPLEConfig
from gple_tpu.dynamics import evolve as EV
from gple_tpu.gp.opt import (
    AVERAGE_TOLERANCE,
    INITIAL_NOISE,
    Optimizer,
    OptResult,
    _fit_once_diagnostics,
    _wstd_jnp,
    moment_kernel_params,
)
from gple_tpu.io.writers import OutputWriters
from gple_tpu.ops import complex_kernels as CK
from gple_tpu.ops import kernels as RK
from gple_tpu.sampler import mc
from gple_tpu.storage import (
    DIAG_INDICES,
    ELEMENTS,
    NUM_ELEMENTS,
    OFFDIAG_INDEX,
    Density,
    GPStates,
    fit_gp_states,
    predict_element,
)
from gple_tpu.utils import ri
from gple_tpu.utils.constants import purity_factor


# -- distribution functions (module-level: stable identity for jit caches) --------

def gp_dist_all(gps: GPStates, pts3):
    """(3, M, PhaseDim) -> (3, M) cutoff GP predictions (main.cpp:75-101)."""
    return jnp.stack([predict_element(gps, k, pts3[k]) for k in range(NUM_ELEMENTS)])


def gp_dist_all_nocut(gps: GPStates, pts3):
    """Raw-mean GP predictions, no cutoff: the default EVOLUTION distribution.
    The reference evolves with the cutoff applied (main.cpp:75-101), which
    zeroes the coherence's spatial tails every tick (~1-2%/tick integral
    leak); see GPLEConfig.evolve_cutoff."""
    return jnp.stack(
        [predict_element(gps, k, pts3[k], with_variance=False) for k in range(NUM_ELEMENTS)]
    )


def gp_dist_coh_cut(gps: GPStates, pts3):
    """Raw-mean diagonals + variance-CUTOFF coherence: evolve_cutoff="coh".

    A near-interpolating (div >= 4) coherence fit extrapolates noise between
    its samples, and the diagonals read that noise at their 3x3 branch points
    through the off-diagonal rotation (dynamics/evolve.py:310-318) -- the
    isolated injection channel of the booster divergence
    (benchmarks/boost_probe.py).  The 1-2 sigma smoothstep cutoff
    (kernel.h:296-332) suppresses exactly the low-signal/high-variance
    region, while the diagonals keep the leak-free raw mean."""
    return jnp.stack(
        [predict_element(gps, k, pts3[k], with_variance=(k == OFFDIAG_INDEX))
         for k in range(NUM_ELEMENTS)]
    )


def _evolve_dist_for(mode):
    """The evolution distribution for a GPLEConfig.evolve_cutoff setting
    (False = raw means, True = full cutoff, "coh" = coherence-only cutoff)."""
    if mode == "coh":
        return gp_dist_coh_cut
    return gp_dist_all if mode else gp_dist_all_nocut


def _gp_dist_elem(gps: GPStates, pts, *, elem: int, cutoff: bool = True):
    return predict_element(gps, elem, pts, with_variance=cutoff)


GP_DIST_ELEMS = tuple(partial(_gp_dist_elem, elem=k) for k in range(NUM_ELEMENTS))
GP_DIST_ELEMS_NOCUT = tuple(
    partial(_gp_dist_elem, elem=k, cutoff=False) for k in range(NUM_ELEMENTS)
)


def _init_dist_elem(params, pts, *, elem: int):
    r0, sigma, pops, phases = params
    row, col = ELEMENTS[elem]
    return mc.initial_distribution(r0, sigma, pts, row, col, pops, phases)


INIT_DIST_ELEMS = tuple(partial(_init_dist_elem, elem=k) for k in range(NUM_ELEMENTS))


def init_dist_all(params, pts3):
    return jnp.stack([INIT_DIST_ELEMS[k](params, pts3[k]) for k in range(NUM_ELEMENTS)])


def _off_extra_slice(extra: Density, k: int):
    """First ``k`` off-diagonal extra points as (pts, rho) for the coherence
    fit, or None when the boost is off.  ``k`` is static."""
    if k <= 0:
        return None
    return (extra.points[OFFDIAG_INDEX, :k], extra.rho[OFFDIAG_INDEX, :k])


def _tick_core(model: str, mass: float, dt: float, density: Density,
               extra: Density, gps: GPStates, diag_params, off_params,
               evolve_dist, track_moments: str, coh_fit_extra: int,
               coh_len_div: float, block_diag: bool):
    """THE tick body, shared by every trajectory path (single-tick dispatch,
    chunked scan, whole-segment fused scan): evolve density + extra points,
    the is-very-small activation test, optional per-tick moment tracking of
    the kernel parameters, and the GP refactorization from the moved points
    (the reference's per-tick work, main.cpp:135-190).  One definition means
    a physics change cannot silently diverge between the paths -- the
    round-4 drift-trigger fix had to be hand-replicated into three
    near-identical copies.

    ``evolve_dist`` feeds the trajectory dynamics (no cutoff by default, see
    GPLEConfig.evolve_cutoff); the is-very-small activation test always uses
    the cutoff distribution for noise robustness (evolve.cpp:445-478)."""
    new_density = EV.evolve_step(model, mass, dt, density, evolve_dist, gps)
    new_extra = EV.evolve_step(model, mass, dt, extra, evolve_dist, gps)
    small = EV.is_very_small(model, mass, dt, new_density, gp_dist_all, gps)
    dgp, ogp = (
        moment_kernel_params(
            new_density, diag_params, off_params,
            off_extra=_off_extra_slice(new_extra, coh_fit_extra),
            off_len_div=coh_len_div, track_diag=(track_moments == "all"),
        )
        if track_moments != "none" else (diag_params, off_params)
    )
    new_gps = fit_gp_states(dgp, ogp, new_density,
                            off_extra=_off_extra_slice(new_extra, coh_fit_extra),
                            block_diag=block_diag)
    return new_density, new_extra, small, new_gps


@partial(jax.jit, static_argnums=(0, 1, 2, 8, 9, 10, 11, 12))
def _tick_fused(model: str, mass: float, dt: float, density: Density,
                extra: Density, gps: GPStates, diag_params, off_params,
                evolve_dist=gp_dist_all_nocut, track_moments: str = "none",
                coh_fit_extra: int = 0, coh_len_div: float = 2.0,
                block_diag: bool = False):
    """One tick's device work in ONE dispatch (``_tick_core``) plus the
    drift-check scalars.  The per-tick host loop then costs a single
    host round-trip instead of six (the reference does the same work in one
    process, main.cpp:135-190)."""
    new_density, new_extra, small, new_gps = _tick_core(
        model, mass, dt, density, extra, gps, diag_params, off_params,
        evolve_dist, track_moments, coh_fit_extra, coh_len_div, block_diag,
    )
    mc_purity = jnp.sum(OBS.purity_each_element(new_density))
    return (new_density, new_extra, small, new_gps, new_gps.population(),
            new_gps.purity(), mc_purity)


@partial(jax.jit, static_argnums=(0, 1, 2, 8, 9, 10, 11, 12, 13))
def _ticks_scan(model: str, mass: float, dt: float, density: Density,
                extra: Density, gps: GPStates, diag_params, off_params,
                n_ticks: int, evolve_dist=gp_dist_all_nocut,
                track_moments: str = "none", coh_fit_extra: int = 0,
                coh_len_div: float = 2.0, block_diag: bool = False):
    """A whole CHUNK of ticks in ONE dispatch: ``lax.scan`` over
    ``_tick_core``, carrying (density, extra, gps).  Per-tick activation
    flags are stacked out so the host can detect an element change mid-chunk
    and fall back to the tick-by-tick path (rare).  This is the
    scan-over-ticks form SURVEY.md section 7 calls for: one dispatch and
    one host sync per chunk instead of per tick."""

    def body(carry, _):
        density, extra, gps = carry
        new_density, new_extra, small, new_gps = _tick_core(
            model, mass, dt, density, extra, gps, diag_params, off_params,
            evolve_dist, track_moments, coh_fit_extra, coh_len_div,
            block_diag,
        )
        return (new_density, new_extra, new_gps), small

    (density, extra, gps), smalls = jax.lax.scan(
        body, (density, extra, gps), None, length=n_ticks
    )
    mc_purity = jnp.sum(OBS.purity_each_element(density))
    return (density, extra, gps, smalls, gps.population(), gps.purity(),
            mc_purity)


_observe_all = partial(jax.jit, static_argnums=(0, 3))(OBS.observe_all)


def _regen_extra_core(use_cutoff, coh_k: int, n_extra: int,
                      density: Density, prev_extra: Density, gps, keys) -> Density:
    """Regenerate the extra clouds from a fresh fit (reference mc.cpp:59-120
    via main.cpp:165-172), traced inline: one key per element (zeros for
    inactive elements -- their outputs are masked), carried booster labels
    preserved for the off-diagonal (see GPLEDriver._make_extra).
    ``use_cutoff`` is the static GPLEConfig.evolve_cutoff mode
    (False / True / "coh")."""
    if use_cutoff == "coh":
        dists = tuple(
            GP_DIST_ELEMS[k] if k == OFFDIAG_INDEX else GP_DIST_ELEMS_NOCUT[k]
            for k in range(NUM_ELEMENTS)
        )
    else:
        dists = GP_DIST_ELEMS if use_cutoff else GP_DIST_ELEMS_NOCUT
    pts, rho = [], []
    for k in range(NUM_ELEMENTS):
        p, r = mc.generate_extra_points_element(
            keys[k], density.points[k], n_extra, dists[k], gps
        )
        if k == OFFDIAG_INDEX and coh_k > 0:
            # carried booster cloud: evolved labels survive reoptimization
            carry = density.active[k] & prev_extra.active[k]
            p = p.at[:coh_k].set(
                jnp.where(carry, prev_extra.points[k, :coh_k], p[:coh_k])
            )
            r = r.at[:coh_k].set(
                jnp.where(carry, prev_extra.rho[k, :coh_k], r[:coh_k])
            )
        inactive_p = jnp.tile(density.points[k][:1], (n_extra, 1))
        p = jnp.where(density.active[k], p, inactive_p)
        r = jnp.where(density.active[k], r, 0.0)
        pts.append(p)
        rho.append(r)
    return Density(points=jnp.stack(pts), rho=jnp.stack(rho),
                   active=density.active)


@partial(jax.jit, static_argnums=(0, 1, 2, 8))
def _reopt_epilogue(use_cutoff, coh_k: int, n_extra: int,
                    density: Density, prev_extra: Density,
                    diag_params, off_params, keys,
                    block_diag: bool = False):
    """Everything after a reoptimization's parameter choice, in ONE dispatch:
    refit the GP states from the (possibly re-selected) cloud, regenerate the
    extra clouds labeled by the fresh fit (reference mc.cpp:59-120 via
    main.cpp:165-172), and the fit-reference scalars for the drift check.
    Replaces a ~6-dispatch host sequence (refit, 3 extra-point walks, 2
    scalar pulls)."""
    gps = fit_gp_states(diag_params, off_params, density,
                        off_extra=_off_extra_slice(prev_extra, coh_k),
                        block_diag=block_diag)
    extra = _regen_extra_core(use_cutoff, coh_k, n_extra, density, prev_extra,
                              gps, keys)
    return gps, extra, gps.population(), gps.purity()


@partial(jax.jit, static_argnums=(0, 5))
def _fit_states_obs(coh_k: int, diag_params, off_params,
                    density: Density, extra: Density,
                    block_diag: bool = False):
    """``fit_gp_states`` plus its integral observables in ONE dispatch.

    The init-path refit used to run eagerly op-by-op: hundreds of small
    dispatches, each with its own host round-trip, for what is a
    millisecond of device compute."""
    gps = fit_gp_states(diag_params, off_params, density,
                        off_extra=_off_extra_slice(extra, coh_k),
                        block_diag=block_diag)
    return gps, gps.population(), gps.purity()


#: walk-surrogate grid resolution per phase-space axis; 256 resolves the
#: coherence fringes (grid spacing ~0.05-0.1 in p over a doubled cloud bbox,
#: an order below the SAC fringe wavelength at p0 = 20)
_SURR_RES = 256


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _surrogate_grid(model: str, mass: float, dt: float, elem: int,
                    use_cutoff, gps, lo, hi):
    """|backward-branching prediction| of one element on a regular grid, in
    ONE batched predictor call (the Metropolis chains then interpolate it,
    see mc.element_monte_carlo ``walk``)."""
    xs = jnp.linspace(lo[0], hi[0], _SURR_RES)
    ps = jnp.linspace(lo[1], hi[1], _SURR_RES)
    X, P = jnp.meshgrid(xs, ps, indexing="ij")
    pts = jnp.stack([X.ravel(), P.ravel()], axis=-1)
    dist = _evolve_dist_for(use_cutoff)
    vals = EV.predict_new_points(model, mass, dt, pts, elem, dist, gps)
    return ri.absval(vals).reshape(_SURR_RES, _SURR_RES)


def _surrogate_dist(params, pts):
    """Bilinear interpolation of a `_surrogate_grid`, zero outside the box.
    RI-shaped (imaginary part 0) so the Metropolis kernel's |.| contract
    holds; labels are NEVER taken from this (mc.element_monte_carlo)."""
    grid, lo, hi = params
    res = grid.shape[0]
    u = (pts - lo) / (hi - lo) * (res - 1)
    i = jnp.clip(jnp.floor(u), 0, res - 2).astype(jnp.int32)
    f = u - i
    w = (grid[i[:, 0], i[:, 1]] * (1 - f[:, 0]) * (1 - f[:, 1])
         + grid[i[:, 0] + 1, i[:, 1]] * f[:, 0] * (1 - f[:, 1])
         + grid[i[:, 0], i[:, 1] + 1] * (1 - f[:, 0]) * f[:, 1]
         + grid[i[:, 0] + 1, i[:, 1] + 1] * f[:, 0] * f[:, 1])
    inside = jnp.all((pts >= lo) & (pts <= hi), axis=-1)
    w = jnp.where(inside, w, 0.0)
    return jnp.stack([w, jnp.zeros_like(w)], axis=-1)


def _moment_reopt_core(coh_k: int, off_len_div: float,
                       density: Density, extra: Density,
                       diag_params, off_params, block_diag: bool = False):
    """In-graph replica of the host moment reoptimization
    (``Optimizer._moment_impl`` + ``_finish`` + ``fitted_params``):
    moment lengthscales, one diagnostics fit for the analytic magnitudes,
    and the assembled kernel parameter pytrees.  Pure function of the
    current clouds, so a whole-trajectory scan can reoptimize on schedule
    without a host round-trip (the reference reopts in-process every
    ``reopt_freq`` ticks, main.cpp:165-172)."""
    diag_idx = jnp.asarray(DIAG_INDICES)
    dmask = density.active[diag_idx]
    dlens = jax.vmap(_wstd_jnp)(
        density.points[diag_idx], density.rho[diag_idx, :, 0]
    ) / 2.0
    dlens = jnp.where(dmask[:, None], dlens, diag_params.lengths)
    o_pts = density.points[OFFDIAG_INDEX]
    o_rho = density.rho[OFFDIAG_INDEX]
    oe = _off_extra_slice(extra, coh_k)
    if oe is not None:
        o_pts = jnp.concatenate([o_pts, oe[0]], axis=0)
        o_rho = jnp.concatenate([o_rho, oe[1]], axis=0)
    lr = _wstd_jnp(o_pts, o_rho[:, 0]) / off_len_div
    li = _wstd_jnp(o_pts, o_rho[:, 1]) / off_len_div
    mr = jnp.sqrt(jnp.mean(o_rho[:, 0] ** 2)) + 1e-30
    mi = jnp.sqrt(jnp.mean(o_rho[:, 1] ** 2)) + 1e-30
    new_flat = jnp.concatenate([mr[None], lr, mi[None], li, jnp.zeros(1)])
    prev_flat = jnp.concatenate([
        off_params.real_magnitude[None], off_params.real_lengths,
        off_params.imag_magnitude[None], off_params.imag_lengths,
        off_params.corr[None],
    ])
    act_o = density.active[OFFDIAG_INDEX]
    off_flat = jnp.where(act_o, new_flat, prev_flat)
    fdt = density.points.dtype
    data = dict(
        dpts=density.points[diag_idx], drho=density.rho[diag_idx][..., 0],
        depts=extra.points[diag_idx], derho=extra.rho[diag_idx][..., 0],
        opts=density.points[OFFDIAG_INDEX], orho=density.rho[OFFDIAG_INDEX],
        oepts=extra.points[OFFDIAG_INDEX], oerho=extra.rho[OFFDIAG_INDEX],
        dmask=dmask.astype(fdt), omask=act_o.astype(fdt),
    )
    err, mags, off_mag = _fit_once_diagnostics(dlens, off_flat, data, block_diag)
    d = dlens.shape[-1]
    diag_new = RK.KernelParams(
        magnitude=jnp.where(dmask, mags, 1.0), lengths=dlens,
        noise=jnp.full(2, INITIAL_NOISE, dtype=fdt),
    )
    off_new = CK.ComplexKernelParams(
        magnitude=jnp.where(act_o, off_mag, 1.0),
        real_magnitude=off_flat[0], real_lengths=off_flat[1:1 + d],
        imag_magnitude=off_flat[1 + d], imag_lengths=off_flat[2 + d:2 + 2 * d],
        noise=jnp.asarray(INITIAL_NOISE, dtype=fdt), corr=off_flat[-1],
    )
    return diag_new, off_new, err


@partial(jax.jit, static_argnums=(1,))
def _split_chain(key, count: int):
    """``count`` sequential ``jax.random.split`` subkeys in one dispatch,
    bitwise-identical to ``count`` calls of :meth:`GPLEDriver._split` (the
    fused trajectory scan must consume the RNG stream exactly like the host
    loop it replaces, so an event replay resumes the same stream)."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, sub

    return jax.lax.scan(body, key, None, length=count)


@partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 25))
def _ticks_scan_fused(model: str, mass: float, dt: float, n_periods: int,
                      reopt_freq: int, use_cutoff, track_moments: str,
                      coh_k: int, n_extra: int, off_len_div: float,
                      measured_target: bool, pop_rescale: bool,
                      density: Density, extra: Density, gps: GPStates,
                      diag_params, off_params,
                      check_mask, keys,
                      fit_pop, fit_pur, fit_target,
                      pur_scale, fixed_target, pop_sum0,
                      block_diag: bool = False):
    """A whole trajectory SEGMENT -- ``n_periods`` reoptimization periods of
    ``reopt_freq`` ticks each, scheduled moment reopts included -- in ONE
    dispatch.

    The per-boundary chunking of :meth:`GPLEDriver._advance_chunk` pays ~2
    blocking host syncs per 10 ticks plus ~6 per reoptimization.  This scan folds the scheduled
    moment reopt (closed form, `_moment_reopt_core`) and the extra-point
    regeneration (pre-split keys) into the tick scan, so the host syncs once
    per segment and only intervenes on rare EVENTS -- element activation,
    conservation drift, cloud re-selection -- which are detected from the
    stacked flags and replayed through the slow path.  Matches the per-tick
    control flow of the reference (main.cpp:135-202) compiled into a single
    XLA program.

    Structure: an outer scan over periods, each an inner scan over
    ``reopt_freq`` plain ticks followed by an UNCONDITIONAL reopt -- a
    ``lax.cond`` per tick would either execute both branches and select
    (making every tick pay the reopt's cold refit) or read its predicate on
    the host (a sync per tick on XLA:GPU).  The caller must align segments so each
    period ends exactly on a scheduled reopt tick.

    ``check_mask`` (n_periods, reopt_freq) marks the ticks where the chunked
    host loop would have evaluated the conservation-drift trigger (chunk
    ends and non-reopt boundaries), so fused and chunked paths take
    identical decisions.  ``keys`` (n_periods, NUM_ELEMENTS, 2) are the
    pre-split extra-regeneration keys, one row per scheduled reopt.

    The stacked per-tick observables of a period's FINAL tick are computed
    pre-reopt; the post-reopt values the host loop would report are returned
    separately as ``obs_last`` and spliced in by the caller.
    """
    evolve_dist = _evolve_dist_for(use_cutoff)

    def tick(carry, check_i):
        density, extra, gps, dp, op, fpop, fpur, ftgt = carry
        new_density, new_extra, small, new_gps = _tick_core(
            model, mass, dt, density, extra, gps, dp, op, evolve_dist,
            track_moments, coh_k, off_len_div, block_diag,
        )
        pop = new_gps.population()
        pur = new_gps.purity()
        mc_pur = jnp.sum(OBS.purity_each_element(new_density))
        target = (mc_pur * pur_scale) if measured_target else fixed_target
        # conservation-drift trigger, same form as GPLEDriver._drift_detected
        tol = 2.0 * AVERAGE_TOLERANCE
        ratio = pop / fpop
        pop_ok = (ratio > 1.0 - tol) & (ratio < 1.0 + tol)
        pur_cap = (1.0 + tol) * target * (fpur / ftgt)
        drift = check_i & ((pur > pur_cap) | (~pop_ok))
        obs = OBS.observe_all(model, new_density, new_gps, mass)
        out = dict(small=small, drift=drift, target=target, obs=obs)
        return (new_density, new_extra, new_gps, dp, op,
                fpop, fpur, ftgt), out

    def period(carry, xs):
        check_p, key_p = xs
        carry, outs = jax.lax.scan(tick, carry, check_p, length=reopt_freq)
        density, extra, gps, dp, op, fpop, fpur, ftgt = carry
        # cloud re-selection flags, evaluated where the host would (pre-reopt)
        resel = jnp.any(_cloud_drift_flags(density))
        target = outs["target"][-1]
        pop_s = jnp.asarray(1.0, dtype=density.rho.dtype)
        if pop_rescale:
            # population-conservation rescale of the diagonal labels, the
            # in-graph replica of GPLEDriver._pop_conservation_rescale
            # (GPLEConfig.pop_rescale); out-of-band factors skip
            diag_idx = jnp.asarray(DIAG_INDICES)
            tot = jnp.sum(density.rho[diag_idx][..., 0])
            s = pop_sum0 / jnp.where(tot == 0.0, 1.0, tot)
            s = jnp.where((tot > 0.0) & (s >= 0.5) & (s <= 2.0), s, 1.0)
            pop_s = s
            density = density._replace(
                rho=density.rho.at[diag_idx, :, 0].multiply(s))
            if measured_target:
                target = (jnp.sum(OBS.purity_each_element(density))
                          * pur_scale)
        dp2, op2, err = _moment_reopt_core(coh_k, off_len_div, density, extra,
                                           dp, op, block_diag)
        gps2 = fit_gp_states(dp2, op2, density,
                             off_extra=_off_extra_slice(extra, coh_k),
                             block_diag=block_diag)
        extra2 = _regen_extra_core(use_cutoff, coh_k, n_extra, density, extra,
                                   gps2, key_p)
        obs_last = OBS.observe_all(model, density, gps2, mass)
        new_carry = (density, extra2, gps2, dp2, op2,
                     gps2.population(), gps2.purity(),
                     jnp.maximum(target, 1e-30))
        out = dict(small=outs["small"], drift=outs["drift"], resel=resel,
                   err=err, obs=outs["obs"], obs_last=obs_last, pop_s=pop_s)
        return new_carry, out

    carry = (density, extra, gps, diag_params, off_params,
             fit_pop, fit_pur, fit_target)
    carry, stacks = jax.lax.scan(
        period, carry, (check_mask, keys), length=n_periods
    )
    return carry, stacks


@jax.jit
def _cloud_drift_flags(density: Density) -> jnp.ndarray:
    """Per-element drift criterion of :meth:`GPLEDriver._track_clouds`, on
    device: |rho|-weighted label mean off the cloud mean by > half a cloud
    sigma in any phase-space dim.  One scalar-sized dispatch per reopt; the
    host pulls the full point clouds only when a flag actually fires
    (a trajectory has only a few real re-selections)."""
    w = jnp.sqrt(ri.abs2(density.rho))           # (3, N)
    wsum = jnp.sum(w, axis=1)                     # (3,)
    com = jnp.einsum("knd,kn->kd", density.points, w) / jnp.maximum(
        wsum[:, None], 1e-300
    )
    mean = jnp.mean(density.points, axis=1)
    std = jnp.maximum(jnp.std(density.points, axis=1), 1e-10)
    drift = jnp.max(jnp.abs(com - mean) / std, axis=1)
    return density.active & (wsum > 0.0) & (drift > 0.5)


@partial(jax.jit, static_argnums=(0,))
def _grid_predictions(model_unused, gps: GPStates, grid_pts):
    """Cutoff prediction + variance of every element on the output grid."""
    preds, variances = [], []
    for k in range(NUM_ELEMENTS):
        if k == OFFDIAG_INDEX:
            _, var, cut = CK.predict_complex(gps.offdiag, grid_pts)
        else:
            d = 0 if k == 0 else 1
            state = jax.tree.map(lambda a: a[d], gps.diag)
            _, var, mean_cut = RK.predict_real(state, grid_pts)
            cut = ri.ri(mean_cut)
        active = gps.active[k]
        preds.append(jnp.where(active, cut, 0.0))
        variances.append(jnp.where(active, var, 0.0))
    return jnp.stack(preds), jnp.stack(variances)


@dataclasses.dataclass
class TickRecord:
    time: float
    population_prm: float
    #: per-surface populations by the ANALYTIC parameter integral, normalized
    #: (the reference writes both estimators to ave.txt, output.cpp:41-118;
    #: unlike the MC sum this one has no sampling-shape bias and is pinned by
    #: the optimizer's conservation constraints)
    population_prm_each: np.ndarray
    population_mci: np.ndarray
    energy_prm: float
    energy_mci: float
    purity_prm: float
    purity_mci: float
    x_average: float
    opt_type: str


class GPLEDriver:
    def __init__(self, cfg: GPLEConfig, outdir: Optional[str] = None, verbose: bool = False,
                 profile_dir: Optional[str] = None):
        from gple_tpu.utils.cache import enable_persistent_cache

        enable_persistent_cache()
        self.cfg = cfg
        self.verbose = verbose
        self.writers = OutputWriters(outdir) if outdir else None
        self.key = jax.random.PRNGKey(cfg.seed)
        self.mc_params = [mc.MCParameters() for _ in range(NUM_ELEMENTS)]
        self.history: List[TickRecord] = []
        self._grid = jnp.asarray(cfg.phase_grids()) if outdir else None
        #: jax.profiler trace directory (the reference only has wall-clock
        #: deltas in run.log, SURVEY.md section 5; this is the real profiler)
        self.profile_dir = profile_dir
        #: cumulative per-phase wall times (evolve / refit / optimize / output).
        #: "optimize" is further attributed to its three sub-phases --
        #: opt_reselect (cloud re-selection + MC re-tuning), opt_tune
        #: (hyperparameter search / moment fit), opt_fit (refit + extra-point
        #: regeneration) -- so a slow reopt names its dominant term
        self.phase_times = {
            "init": 0.0, "seed": 0.0,
            "evolve": 0.0, "refit": 0.0, "optimize": 0.0, "output": 0.0,
            "opt_reselect": 0.0, "opt_tune": 0.0, "opt_fit": 0.0,
            # fused = whole segments (ticks + in-graph scheduled reopts) in
            # one dispatch; fused_abort = segments rolled back on an event
            "fused": 0.0, "fused_abort": 0.0,
        }
        #: event counters for the non-adiabatic machinery (activation of new
        #: density-matrix elements, drift-triggered cloud re-selections) --
        #: lets tests assert the crossing physics actually fired
        self.stats = {"element_activations": 0, "cloud_reselections": 0}
        #: per-tick moment hyperparameter tracking mode: "none", "all", or
        #: "off" (coherence only; see GPLEConfig.moment_per_tick).  Only
        #: meaningful under the moment optimizer -- the ladder's constrained
        #: params must not be overwritten mid-flight.
        if cfg.opt_mode != "moment" or not cfg.moment_per_tick:
            self._track_moments = "none"
        else:
            self._track_moments = (
                "off" if cfg.moment_per_tick == "off" else "all"
            )
        # per-driver new-point distribution functions (stable identities)
        self._new_pt_dists = tuple(
            partial(self._new_point_dist, elem=k) for k in range(NUM_ELEMENTS)
        )
        #: static coherence-boost size (see GPLEConfig.coh_fit_extra)
        self._coh_k = min(int(cfg.coh_fit_extra), cfg.num_extra_points)
        #: EFFECTIVE coherence lengthscale divisor: starts at the configured
        #: value, stickily halved by the fit-health backoff
        #: (GPLEConfig.coh_fit_health_factor)
        self._coh_div_eff = float(cfg.coh_len_div)
        #: event ticks observed this run (persisted as fusion hints when the
        #: init cache is on; see _event_hints_path)
        self._event_ticks = set()

    def _init_cache_path(self) -> str:
        """Path of the cached initialization state (GPLEConfig.init_cache),
        keyed by EVERY config field except the cache knob itself (any field
        could influence the init walk, the first fit, or the RNG stream)."""
        import dataclasses as _dc
        import hashlib
        import os

        from gple_tpu.utils.cache import STATE_DIR

        fields = _dc.asdict(self.cfg)
        fields.pop("init_cache", None)
        key = hashlib.sha1(repr(sorted(fields.items())).encode()).hexdigest()[:16]
        os.makedirs(STATE_DIR, exist_ok=True)
        return os.path.join(STATE_DIR, f"init_{key}.npz")

    def _event_hints_path(self) -> str:
        """Sidecar of :meth:`_init_cache_path` recording the EVENT ticks
        (element activations, drift reopts, reselections) observed on a
        previous run of this exact config.  Runs are deterministic given the
        config (the init cache's own contract), so a recorded event tick
        predicts this run's events exactly: the fused path pre-blocks around
        them instead of paying a full-segment abort (measured 118-196 s of
        ``fused_abort`` waste per round-3 run)."""
        import os

        d, base = os.path.split(self._init_cache_path())
        return os.path.join(
            d, base.replace("init_", "events_").replace(".npz", ".json"))

    def _block_diag(self) -> bool:
        """True when the complex fit may run block-diagonal (corr = 0): the
        moment optimizer never sets a nonzero Re-Im correlation, so its fits
        split into two (N, N) SPD solves -- 4x fewer flops on the step's
        dominant matmul chain (CK.fit_complex).  Checked against the live
        parameter vector so a resumed legacy checkpoint (corr pinned to 1)
        can never silently drop its correlation."""
        if self.cfg.opt_mode != "moment":
            return False
        opt = getattr(self, "optimizer", None)
        return opt is None or float(np.asarray(opt.off_params)[-1]) == 0.0

    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)

    def _split(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def _new_point_dist(self, params, pts, *, elem: int):
        gps = params
        dist = _evolve_dist_for(self.cfg.evolve_cutoff)
        return EV.predict_new_points(
            self.cfg.model, self.cfg.mass, self.cfg.dt, pts, elem, dist, gps
        )

    # -- initialization (main.cpp:25-73) ------------------------------------------
    def initialize(self):
        import time as _time

        _marks = [("start", _time.perf_counter())]
        cfg = self.cfg
        pops = cfg.initial_population
        active = np.array(
            [pops[i] > 0 and pops[j] > 0 for (i, j) in ELEMENTS], dtype=bool
        )
        init_params = (
            jnp.asarray(cfg.r0), jnp.asarray(cfg.sigma_r0),
            jnp.asarray(pops), jnp.asarray(cfg.initial_phase_factor),
        )
        n = cfg.num_points
        pts = jnp.tile(jnp.asarray(cfg.r0)[None, None, :], (NUM_ELEMENTS, n, 1))
        rho = init_dist_all(init_params, pts)  # (3, N, 2) RI
        density = Density(points=pts, rho=rho, active=jnp.asarray(active))
        # Metropolis selection of each active element (main.cpp:57)
        new_pts, new_rho = [], []
        for k in range(NUM_ELEMENTS):
            if active[k]:
                p, r, self.mc_params[k] = mc.element_monte_carlo(
                    self._split(), INIT_DIST_ELEMS[k], init_params,
                    density.points[k], self.mc_params[k], tune=True,
                )
            else:
                p, r = density.points[k], density.rho[k]
            new_pts.append(p)
            new_rho.append(r)
        density = Density(
            points=jnp.stack(new_pts), rho=jnp.stack(new_rho), active=jnp.asarray(active)
        )
        _marks.append(("mc_select", _time.perf_counter()))
        # conserved targets (main.cpp:59-66)
        energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
        weights = np.asarray(pops) ** 2
        self.total_energy = float(np.sum(weights * np.asarray(energies)) / weights.sum())
        self.purity = 1.0
        initial_mc_purity = float(
            jnp.sum(OBS.purity_each_element(density)) * purity_factor(cfg.dim)
        )
        self.purity_ratio = self.purity / initial_mc_purity
        #: conserved total-population numerator (GPLEConfig.pop_rescale)
        self._pop_sum0 = float(
            jnp.sum(density.rho[jnp.asarray(DIAG_INDICES)][..., 0]))
        # extra points (main.cpp:69); set before the first _refit, which
        # reads self.extra when the coherence boost is on
        extra = self._make_extra(density, INIT_DIST_ELEMS, init_params)
        self.extra = extra
        _marks.append(("extra", _time.perf_counter()))
        # optimizer + first fit (main.cpp:71-74)
        self.optimizer = Optimizer(
            model=cfg.model, mass=cfg.mass, total_energy=self.total_energy,
            purity=self.purity, sigma_r0=np.asarray(cfg.sigma_r0),
            lbfgs_steps=cfg.opt_steps_initial,
            corr_bounds=(1.0, 1.0) if cfg.reference_parity else Optimizer.corr_bounds,
            opt_mode=cfg.opt_mode, off_len_div=cfg.coh_len_div,
            coh_fit_extra=self._coh_k,
        )
        self.opt_result = self.optimizer.optimize(density, extra, energies)
        _marks.append(("optimize", _time.perf_counter()))
        # in-trajectory reopts warm-start near the optimum: fewer steps
        self.optimizer.lbfgs_steps = cfg.opt_steps_reopt
        self.gps = self._refit(density)
        self._record_fit_ref(self.purity)
        self.density = density
        self.extra = extra
        _marks.append(("refit", _time.perf_counter()))
        self._log("init phases: " + ", ".join(
            f"{name}={t1 - t0:.1f}s"
            for (name, t1), (_, t0) in zip(_marks[1:], _marks[:-1])
        ))
        return density

    def _make_extra(self, density: Density, dist_elems, dist_params) -> Density:
        """Regenerate the extra clouds (reference mc.cpp:59-120).

        With the coherence boost on, the first ``_coh_k`` off-diagonal extras
        are a CARRIED booster cloud: their evolved labels are preserved across
        re-optimizations instead of being reset to GP predictions -- resetting
        them wipes exactly the independent information the booster exists to
        carry (measured: a GP-relabeled booster buys nothing, SAC crossing
        0.0501 vs 0.0484 baseline, while the carried decompose booster
        reaches 0.0130)."""
        n_extra = self.cfg.num_extra_points
        prev = getattr(self, "extra", None)
        pts, rho = [], []
        for k in range(NUM_ELEMENTS):
            if bool(density.active[k]):
                p, r = mc.generate_extra_points_element(
                    self._split(), density.points[k], n_extra, dist_elems[k], dist_params
                )
                if (k == OFFDIAG_INDEX and self._coh_k > 0 and prev is not None
                        and bool(prev.active[k])):
                    kk = self._coh_k
                    p = p.at[:kk].set(prev.points[k, :kk])
                    r = r.at[:kk].set(prev.rho[k, :kk])
            else:
                p = jnp.tile(density.points[k][:1], (n_extra, 1))
                r = jnp.zeros((n_extra, 2), dtype=p.dtype)
            pts.append(p)
            rho.append(r)
        return Density(points=jnp.stack(pts), rho=jnp.stack(rho), active=density.active)

    def _refit(self, density: Density) -> GPStates:
        diag_params, off_params = self.optimizer.fitted_params()
        gps, pop, pur = _fit_states_obs(self._coh_k, diag_params, off_params,
                                        density, self.extra, self._block_diag())
        # stash the integral observables so a following _record_fit_ref
        # does not re-dispatch them eagerly
        self._fit_obs = (pop, pur)
        return gps

    def _record_fit_ref(self, target_purity: float) -> None:
        """Snapshot the freshly fitted GP's integral observables.

        The in-trajectory drift checks compare against these REFERENCE values
        rather than the ideal targets: under the constrained ladder the two
        coincide (population = 1, purity = target within tolerance), but the
        moment-mode fit carries a systematic small-N integral bias (the GP
        mean dips between sample points), and triggering on the bias itself
        would force a futile reoptimize-and-reselect every chunk."""
        pop, pur = self.__dict__.pop("_fit_obs", (None, None))
        if pop is None:
            pop, pur = self.gps.population(), self.gps.purity()
        self._fit_ref = {
            "pop": float(pop),
            "pur": float(pur),
            "target": max(float(target_purity), 1e-30),
        }

    def _drift_detected(self, pop: float, pur: float, target_purity: float) -> bool:
        """Conservation-drift trigger (main.cpp:174-189), relative form."""
        ref = self._fit_ref
        tol = 2.0 * AVERAGE_TOLERANCE
        pop_ok = (1.0 - tol) < pop / ref["pop"] < (1.0 + tol)
        pur_cap = (1.0 + tol) * target_purity * (ref["pur"] / ref["target"])
        return pur > pur_cap or not pop_ok

    # -- a chunk of pure evolve ticks in one dispatch -------------------------------
    def _advance_chunk(self, n_ticks: int) -> bool:
        """Advance ``n_ticks`` ticks with ONE ``_ticks_scan`` dispatch.

        Returns False (state untouched) if an element activated mid-chunk --
        the caller then replays the chunk tick-by-tick through :meth:`step`.
        A conservation-drift check runs at the chunk end (the per-tick checks
        of the reference, main.cpp:174-189, at chunk granularity)."""
        import time as _time

        cfg = self.cfg
        t0 = _time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        evolve_dist = _evolve_dist_for(cfg.evolve_cutoff)
        density, extra, gps, smalls, pop, pur, mc_pur = _ticks_scan(
            cfg.model, cfg.mass, cfg.dt, self.density, self.extra, self.gps,
            diag_params, off_params, n_ticks, evolve_dist, self._track_moments,
            self._coh_k, self._coh_div_eff, self._block_diag(),
        )
        # one host pull for every chunk-boundary scalar (each float()/asarray
        # is its own device-to-host round-trip)
        smalls, pop, pur, mc_pur = jax.device_get((smalls, pop, pur, mc_pur))
        active = np.asarray(self.density.active)
        if np.any((~smalls) != active[None, :]):
            return False
        self.phase_times["evolve"] += _time.perf_counter() - t0
        self.density, self.extra, self.gps = density, extra, gps
        measured_purity = float(mc_pur) * purity_factor(cfg.dim) * self.purity_ratio
        target_purity = (
            measured_purity if cfg.purity_target == "measured" else self.purity
        )
        if self._drift_detected(float(pop), float(pur), target_purity):
            self._reoptimize(target_purity)
        return True

    def _coh_purity_rescale(self) -> float:
        """Scalar conservation rescale of the coherence labels (main cloud +
        carried booster slots) against the run's INITIAL purity; returns the
        factor applied (1.0 = no-op).  See GPLEConfig.coh_boost_rescale for
        the measured instability this clamps; the move itself is the
        reference's conservation-rescale idea (test/gpr.cpp:913-992) applied
        to the third tracked invariant."""
        import math

        pf = purity_factor(self.cfg.dim) * self.purity_ratio
        m = np.asarray(OBS.purity_each_element(self.density))
        p_diag = float(m[0, 0] + m[1, 1]) * pf
        p_off = float(m[0, 1] + m[1, 0]) * pf  # off-diagonal counted twice
        if p_off <= 0.0:
            return 1.0
        s = math.sqrt(max(self.purity - p_diag, 0.0) / p_off)
        if s >= 1.0:
            return 1.0
        self.density = self.density._replace(
            rho=self.density.rho.at[OFFDIAG_INDEX].multiply(s)
        )
        if self._coh_k > 0:
            self.extra = self.extra._replace(
                rho=self.extra.rho.at[OFFDIAG_INDEX, : self._coh_k].multiply(s)
            )
        self.stats["coh_rescales"] = self.stats.get("coh_rescales", 0) + 1
        return s

    def _pop_conservation_rescale(self) -> float:
        """Scalar conservation rescale of the diagonal labels against the
        run's INITIAL total population numerator; returns the factor applied
        (1.0 = no-op / out-of-band skip).  See GPLEConfig.pop_rescale; the
        reference pins the same invariant with its population equality
        constraint at every reoptimization (opt.cpp:644-719)."""
        diag_idx = jnp.asarray(DIAG_INDICES)
        tot = float(jnp.sum(self.density.rho[diag_idx][..., 0]))
        ref = getattr(self, "_pop_sum0", None)
        if ref is None:  # legacy checkpoint: pin from here on
            self._pop_sum0 = tot
            return 1.0
        if not np.isfinite(tot) or tot <= 0.0:
            return 1.0
        s = ref / tot
        if not (0.5 <= s <= 2.0):
            self._log(f"population rescale out of band (s={s:.3f}): skipped")
            return 1.0
        self.density = self.density._replace(
            rho=self.density.rho.at[diag_idx, :, 0].multiply(s))
        if abs(s - 1.0) > 1e-6:
            self.stats["pop_rescales"] = self.stats.get("pop_rescales", 0) + 1
        return s

    def _reoptimize(self, target_purity: float) -> str:
        import time as _time

        cfg = self.cfg
        t0 = _time.perf_counter()
        density = self._track_clouds(self.density)
        self.density = density
        rescaled = False
        if cfg.pop_rescale:
            rescaled = self._pop_conservation_rescale() != 1.0
            density = self.density
        if cfg.coh_boost_rescale:
            s = self._coh_purity_rescale()
            density = self.density
            rescaled |= s < 1.0
        if rescaled and cfg.purity_target == "measured":
            # the caller derived target_purity from the PRE-rescale MC
            # purity; recompute from the clamped labels so the drift cap
            # and (in ladder mode) the purity constraint pin the fit to
            # the density that actually exists now
            target_purity = float(
                jnp.sum(OBS.purity_each_element(density))
            ) * purity_factor(cfg.dim) * self.purity_ratio
        t1 = _time.perf_counter()
        energies = OBS.total_energy_each_surface(cfg.model, density, cfg.mass)
        self.optimizer.purity = target_purity
        self.optimizer.off_len_div = self._coh_div_eff
        self.opt_result = self.optimizer.optimize(density, self.extra, energies)
        t2 = _time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        # consume one RNG split per ACTIVE element, exactly like the host
        # _make_extra loop this replaces, so trajectories are stream-stable
        active = np.asarray(density.active)
        keys = jnp.stack([
            self._split() if active[k] else jnp.zeros(2, dtype=jnp.uint32)
            for k in range(NUM_ELEMENTS)
        ])
        self.gps, self.extra, pop, pur = _reopt_epilogue(
            cfg.evolve_cutoff, self._coh_k, cfg.num_extra_points,
            density, self.extra, diag_params, off_params, keys,
            self._block_diag(),
        )
        # coherence fit-health backoff (GPLEConfig.coh_fit_health_factor):
        # a purity INTEGRAL detached from the purity target means the short-
        # length fit went near-interpolating on unresolvable fringes --
        # stickily lengthen and refit (escalation shape of the reference's
        # check_averages ladder, opt.cpp:1200-1392)
        hf = float(cfg.coh_fit_health_factor)
        while (hf > 0.0 and active[OFFDIAG_INDEX]
               and (self._coh_div_eff > 2.0 or self._coh_k > 0)
               and float(pur) > hf * max(float(target_purity), 1e-30)):
            if self._coh_div_eff > 2.0:
                self._coh_div_eff = max(2.0, self._coh_div_eff / 2.0)
                self.optimizer.off_len_div = self._coh_div_eff
                self.stats["coh_len_backoffs"] = (
                    self.stats.get("coh_len_backoffs", 0) + 1
                )
                self._log(f"coherence fit unhealthy (purity {float(pur):.3f} "
                          f"vs target {target_purity:.3f}): len_div -> "
                          f"{self._coh_div_eff}")
            else:
                # still detached at the div-2 floor: EJECT the carried
                # booster and return to the proven-stable main-cloud-only
                # fit (the round-3 head configuration).  The booster's
                # accuracy value lives in the crossing window; past it the
                # fringes outrun any pointwise cloud (DESIGN.md reading 4)
                # and the carried-label feedback only destabilizes.
                self._coh_k = 0
                self.optimizer.coh_fit_extra = 0
                self.stats["coh_boost_ejected"] = (
                    self.stats.get("coh_boost_ejected", 0) + 1
                )
                self._log(f"coherence fit unhealthy at div-2 floor (purity "
                          f"{float(pur):.3f}): booster EJECTED")
            self.opt_result = self.optimizer.optimize(
                density, self.extra, energies
            )
            diag_params, off_params = self.optimizer.fitted_params()
            self.gps, self.extra, pop, pur = _reopt_epilogue(
                cfg.evolve_cutoff, self._coh_k, cfg.num_extra_points,
                density, self.extra, diag_params, off_params, keys,
                self._block_diag(),
            )
        self._fit_ref = {
            "pop": float(pop), "pur": float(pur),
            "target": max(float(target_purity), 1e-30),
        }
        t3 = _time.perf_counter()
        self.phase_times["opt_reselect"] += t1 - t0
        self.phase_times["opt_tune"] += t2 - t1
        self.phase_times["opt_fit"] += t3 - t2
        self.phase_times["optimize"] += t3 - t0
        return self.opt_result.opt_type

    # -- one tick (main.cpp:135-202) ------------------------------------------------
    def step(self, tick: int) -> str:
        import time as _time

        cfg = self.cfg
        gps = self.gps
        t0 = _time.perf_counter()
        diag_params, off_params = self.optimizer.fitted_params()
        evolve_dist = _evolve_dist_for(cfg.evolve_cutoff)
        density, extra, small, new_gps, pop, pur, mc_pur = _tick_fused(
            cfg.model, cfg.mass, cfg.dt, self.density, self.extra, gps,
            diag_params, off_params, evolve_dist, self._track_moments,
            self._coh_k, self._coh_div_eff, self._block_diag(),
        )
        small, pop, pur, mc_pur = jax.device_get((small, pop, pur, mc_pur))
        self.phase_times["evolve"] += _time.perf_counter() - t0
        old_active = np.asarray(density.active)
        new_active = ~small
        opt_type = "none"
        changed = bool(np.any(new_active != old_active))
        if changed:
            self._event_ticks.add(tick)
            self.stats["element_activations"] += int(np.sum(new_active & ~old_active))
            t_seed = _time.perf_counter()
            density, extra = self._element_change(density, extra, old_active, new_active)
            self.phase_times["seed"] += _time.perf_counter() - t_seed
            # mc_pur from _tick_fused predates the reseeding: recompute so the
            # forced reopt pins the GP purity to the post-seeding point sum
            mc_pur = jnp.sum(OBS.purity_each_element(density))
        # the purity the constrained optimizer pins the GP integrals to
        # (see GPLEConfig.purity_target)
        measured_purity = float(mc_pur) * purity_factor(cfg.dim) * self.purity_ratio
        target_purity = (
            measured_purity if cfg.purity_target == "measured" else self.purity
        )
        needs_opt = changed or (tick % cfg.reopt_freq == 0)
        if not needs_opt:
            # drift check with the refitted states (main.cpp:174-189)
            t0 = _time.perf_counter()
            self.density, self.extra = density, extra
            self.gps = new_gps
            self.phase_times["refit"] += _time.perf_counter() - t0
            if self._drift_detected(float(pop), float(pur), target_purity):
                needs_opt = True
                opt_type = "drift"
                self._event_ticks.add(tick)
        if needs_opt:
            self.density, self.extra = density, extra
            reopt_type = self._reoptimize(target_purity)
            opt_type = reopt_type if opt_type == "none" else opt_type
        return opt_type

    def _relabel_gps(self, density: Density, extra: Density) -> GPStates:
        """GP states for RELABELING walks only (reselection / new-element
        seeding), never for evolution or observables.

        The backward-branching predictor that labels walked points queries
        the GP far from its samples.  With the coherence lengthscale boost on
        (coh_len_div > 2) that fit is near-interpolating and extrapolates
        wildly off-sample -- measured: the div-6 production run diverges
        right after the first cloud reselection (pop 0.98 -> 1.95, purity
        -> 8.1, on the CPU) because the
        (1,1) relabel queried the spiky coherence surface.  Here the SAME
        coherence data is refit at the smooth default div-2 lengthscale
        (scaling the live fit's lengths back by coh_len_div/2) purely for
        the relabel queries."""
        if self._coh_div_eff <= 2.0:
            return self.gps
        live = self.gps.offdiag.params
        scale = self._coh_div_eff / 2.0
        safe = live._replace(
            real_lengths=live.real_lengths * scale,
            imag_lengths=live.imag_lengths * scale,
        )
        off_pts = density.points[OFFDIAG_INDEX]
        off_rho = density.rho[OFFDIAG_INDEX]
        if self._coh_k > 0:
            oe = _off_extra_slice(extra, self._coh_k)
            off_pts = jnp.concatenate([off_pts, oe[0]], axis=0)
            off_rho = jnp.concatenate([off_rho, oe[1]], axis=0)
        off = CK.fit_complex(safe, off_pts, off_rho,
                             block_diag=self._block_diag())
        return GPStates(diag=self.gps.diag, offdiag=off, active=self.gps.active)

    #: relabel-continuity factors outside this band mean the relabel query
    #: itself is corrupt -- reject the re-selection instead of scaling
    RELABEL_SCALE_BAND = (0.2, 5.0)
    #: an element whose own integral is below this fraction of the total
    #: diagonal population numerator is NASCENT: relabels accept the
    #: predictor's fresh scale unscaled (see _relabel_scale)
    RELABEL_NASCENT_FRAC = 0.05

    def _relabel_scale(self, k: int, rho_old, rho_new, nascent_ref=None):
        """Continuity factor for a re-selected element's fresh labels, or
        None when the relabel should be rejected outright.

        A re-selection re-samples the SAME physical field, so the element's
        point-sum estimators (diagonals: sum Re rho, the population
        numerator, observables.py:22-27; coherence: sum |rho|^2, the purity
        share) must be continuous across it -- the raw sums are
        trajectory-ensemble invariants whose scale a fresh Metropolis sample
        does not reproduce.  See GPLEConfig.relabel_conserve; the reference
        enforces the same continuity by constraint-pinned reoptimization
        after its mid-run seeding (opt.cpp:644-719 via main.cpp:145-163).

        NASCENT elements bypass the continuity pin: when the element's own
        integral is tiny against ``nascent_ref`` (the total diagonal
        population numerator), the ratio is noise over noise and its true
        field is GROWING fast (transfer onset) -- there is nothing to
        conserve, and the backward-branching predictor's fresh scale is the
        trustworthy one (exactly as at first activation, where seeding
        accepts predictor labels wholesale).  Without the bypass the band
        rejects every relabel of a growing element (measured: four straight
        (1, 1) rejections through the SAC transfer onset starved tracking
        and detached the diagonal fit)."""
        old = np.asarray(rho_old)
        new = np.asarray(rho_new)
        if k == OFFDIAG_INDEX:
            pre = float(np.sum(old[:, 0] ** 2 + old[:, 1] ** 2))
            post = float(np.sum(new[:, 0] ** 2 + new[:, 1] ** 2))
            # nascent test compares LIKE with LIKE: the L1 sum of |rho| scales
            # with num_points * mean exactly as the diagonal point-sum
            # reference does (an L2 norm scales as sqrt(N) * rms, so at
            # production N a resolved coherence could still classify as
            # nascent and bypass the continuity band)
            pre_l1 = float(np.sum(np.sqrt(old[:, 0] ** 2 + old[:, 1] ** 2)))
            post_l1 = float(np.sum(np.sqrt(new[:, 0] ** 2 + new[:, 1] ** 2)))
            thresh = (self.RELABEL_NASCENT_FRAC * nascent_ref
                      if nascent_ref is not None else None)
            if thresh is not None and pre_l1 < thresh:
                # the bypass trusts the predictor only within nascent SCALE:
                # a relabel claiming the element already carries well beyond
                # the nascent band is a corrupt query, not growth (measured:
                # the div-6 coh-cutoff probe's (1,1) relabel jumped the
                # diagonal sum by -2.8/40 in one tick and NaN'd the fit)
                if post_l1 <= 2.0 * thresh:
                    self.stats["relabel_nascent"] = (
                        self.stats.get("relabel_nascent", 0) + 1)
                    return 1.0
                self._log("nascent relabel REJECTED (post integral "
                          f"{post_l1:.3g} beyond 2x nascent band)")
                return None
            if post <= 0.0 or pre <= 0.0:
                return None
            s = float(np.sqrt(pre / post))
        else:
            pre = float(np.sum(old[:, 0]))
            post = float(np.sum(new[:, 0]))
            thresh = (self.RELABEL_NASCENT_FRAC * nascent_ref
                      if nascent_ref is not None else None)
            if thresh is not None and abs(pre) < thresh:
                # nascent-scale sanity on the accepted labels: a GROWING
                # diagonal's integral is positive and still near nascent
                # scale; a net-negative or many-times-threshold relabel is a
                # corrupt query (the coh-cutoff probe's one-tick -2.8 jump)
                if post > 0.0 and post <= 2.0 * thresh:
                    self.stats["relabel_nascent"] = (
                        self.stats.get("relabel_nascent", 0) + 1)
                    return 1.0
                self._log("nascent relabel REJECTED (post integral "
                          f"{post:.3g} outside (0, 2x nascent band])")
                return None
            if post == 0.0 or pre == 0.0 or (pre > 0) != (post > 0):
                return None  # sign flip: the relabel query is corrupt
            s = pre / post
        lo, hi = self.RELABEL_SCALE_BAND
        if not (lo <= s <= hi) or not np.isfinite(s):
            return None
        return s

    def _walk_surrogate(self, gps, elem: int, density: Density,
                        extra: Density):
        """(walk_fn, walk_params) Metropolis target for ``elem``'s chains
        (see GPLEConfig.mc_walk_surrogate), or None for exact walks.  The
        grid box doubles the union cloud's bounding box, so the walk can
        follow transferred mass that sits sigmas off the seeded points; the
        surrogate is zero outside, which simply rejects proposals there."""
        cfg = self.cfg
        if not cfg.mc_walk_surrogate or density.points.shape[-1] != 2:
            return None
        pts = jnp.concatenate([
            density.points.reshape(-1, 2), extra.points.reshape(-1, 2)
        ])
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        span = hi - lo
        lo = lo - 0.5 * span
        hi = hi + 0.5 * span
        grid = _surrogate_grid(cfg.model, cfg.mass, cfg.dt, elem,
                               cfg.evolve_cutoff, gps, lo, hi)
        return (_surrogate_dist, (grid, lo, hi))

    def _track_clouds(self, density: Density) -> Density:
        """Re-select an element's points from its CURRENT GP density when the
        cloud has drifted off its own mass.

        Points move on classical trajectories of their own surface, but the
        density they carry can migrate elsewhere in phase space -- the
        transferred upper-surface density sits ~2 sigma BELOW the seeded
        points' momenta on Tully A (the physical momentum jump has no
        trajectory counterpart), so the fixed cloud ends up sampling a tail
        and the fit never sees the peak.  When the |rho|-weighted mean of the
        labels deviates from the cloud mean by more than half a cloud sigma,
        walk the points to the current predicted density with the tuned
        Metropolis kernel (the reference's mid-run seeding machinery,
        mc.cpp:407-537, applied on drift rather than only on activation)."""
        if not self.cfg.track_clouds:
            return density
        flags = np.array(_cloud_drift_flags(density))
        if self._coh_k > 0 and not self.cfg.coh_reselect:
            # carried booster alive: the coherence cloud follows its own
            # characteristics and keeps its carried labels -- never re-walk
            # it through a GP relabel query (GPLEConfig.coh_reselect)
            flags[OFFDIAG_INDEX] = False
        if not flags.any():
            return density
        pts = np.array(density.points)   # mutable copies
        rho = np.array(density.rho)
        changed = False
        relabel_gps = None  # lazily built: one smooth refit per reselection event
        for k in range(NUM_ELEMENTS):
            if not flags[k]:
                continue
            self._log(f"element {ELEMENTS[k]} cloud re-selected")
            self.stats["cloud_reselections"] += 1
            if relabel_gps is None:
                relabel_gps = self._relabel_gps(density, self.extra)
            # the Metropolis target is the backward-branching predictor, not
            # the element's own GP: it derives the density from the coherence
            # and the diagonals at branch points, so it has support where the
            # transferred mass lands even though the element's own fit has
            # never sampled there (the reference labels fresh points the same
            # way, new_point_predict at mc.cpp:497-517)
            gps_k = relabel_gps
            if self.cfg.relabel_mask_coh and k != OFFDIAG_INDEX:
                # diagonal relabel with the coherence contribution masked out
                # of the predictor (see GPLEConfig.relabel_mask_coh)
                gps_k = relabel_gps._replace(
                    active=relabel_gps.active.at[OFFDIAG_INDEX].set(False)
                )
            walk = self._walk_surrogate(gps_k, k, density, self.extra)
            p, r, self.mc_params[k] = mc.element_monte_carlo(
                self._split(), self._new_pt_dists[k], gps_k,
                density.points[k], self.mc_params[k], tune=self.cfg.mc_retune,
                walk=walk,
            )
            s = 1.0
            if self.cfg.relabel_conserve:
                nascent_ref = sum(
                    abs(float(np.sum(rho[d][:, 0]))) for d in DIAG_INDICES)
                s = self._relabel_scale(k, density.rho[k], r, nascent_ref)
                if s is None:
                    # the relabel query is corrupt: keep the element's
                    # previous points+labels (see GPLEConfig.relabel_conserve)
                    self._log(f"element {ELEMENTS[k]} relabel REJECTED "
                              f"(integral jump outside band)")
                    self.stats["relabel_rejects"] = (
                        self.stats.get("relabel_rejects", 0) + 1
                    )
                    continue
                r = r * s
                self.stats["relabel_rescales"] = (
                    self.stats.get("relabel_rescales", 0) + 1
                )
            pts[k], rho[k] = np.asarray(p), np.asarray(r)
            if k == OFFDIAG_INDEX and self._coh_k > 0:
                # the carried booster tracks the transferred mass with the
                # same walk (labels from the backward-branching predictor,
                # like any re-selected point), scaled by the SAME continuity
                # factor so booster and main cloud keep representing one field
                kk = self._coh_k
                bp, br, _ = mc.element_monte_carlo(
                    self._split(), self._new_pt_dists[k], relabel_gps,
                    self.extra.points[k, :kk], self.mc_params[k], tune=False,
                    walk=walk,
                )
                e_pts = np.array(self.extra.points)
                e_rho = np.array(self.extra.rho)
                e_pts[k, :kk] = np.asarray(bp)
                e_rho[k, :kk] = np.asarray(br) * s
                self.extra = Density(points=jnp.asarray(e_pts),
                                     rho=jnp.asarray(e_rho),
                                     active=self.extra.active)
            changed = True
        if not changed:
            return density
        return Density(
            points=jnp.asarray(pts), rho=jnp.asarray(rho), active=density.active
        )

    def _element_change(self, density, extra, old_active, new_active):
        """new_element_point_selection (mc.cpp:407-537)."""
        import time as _time

        t_pull = _time.perf_counter()
        pts = np.array(density.points)   # mutable copies
        rho = np.array(density.rho)
        e_pts = np.array(extra.points)
        e_rho = np.array(extra.rho)
        candidates = jnp.asarray(
            np.concatenate(
                [pts.reshape(-1, pts.shape[-1]), e_pts.reshape(-1, 2)]
            )
        )
        gps = self._relabel_gps(density, extra)
        self._log(f"  seed: pull+relabel {_time.perf_counter() - t_pull:.1f}s")
        for k in range(NUM_ELEMENTS):
            if new_active[k] and not old_active[k]:
                t_el = _time.perf_counter()
                self._log(f"element {ELEMENTS[k]} appears")
                walk = self._walk_surrogate(gps, k, density, extra)
                p, r, self.mc_params[k] = mc.seed_new_element(
                    self._split(), candidates, self.cfg.num_points,
                    self._new_pt_dists[k], gps, self.mc_params[k], walk=walk,
                )
                self._log(f"  seed: element {ELEMENTS[k]} walk "
                          f"{_time.perf_counter() - t_el:.1f}s")
                pts[k], rho[k] = np.asarray(p), np.asarray(r)
                if k == OFFDIAG_INDEX and self._coh_k > 0:
                    # seed the carried coherence booster the same way
                    bp, br, _ = mc.seed_new_element(
                        self._split(), candidates, self._coh_k,
                        self._new_pt_dists[k], gps, self.mc_params[k],
                        walk=walk,
                    )
                    e_pts[k, : self._coh_k] = np.asarray(bp)
                    e_rho[k, : self._coh_k] = np.asarray(br)
            elif old_active[k] and not new_active[k]:
                self._log(f"element {ELEMENTS[k]} vanishes")
                rho[k] = 0.0
                if k == OFFDIAG_INDEX and self._coh_k > 0:
                    e_rho[k, : self._coh_k] = 0.0
        density = Density(
            points=jnp.asarray(pts), rho=jnp.asarray(rho), active=jnp.asarray(new_active)
        )
        extra = Density(points=jnp.asarray(e_pts), rho=jnp.asarray(e_rho),
                        active=jnp.asarray(new_active))
        return density, extra

    # -- a fused trajectory segment (scheduled reopts in-graph) ----------------------
    def _advance_fused(self, start_tick: int, n: int, callback=None):
        """Advance ``n`` ticks with scheduled moment reopts and observables
        folded into ONE ``_ticks_scan_fused`` dispatch (one blocking sync).

        Returns ``(ok, stopped)``.  ``ok`` is False when an EVENT fired
        inside the segment -- element activation, conservation drift, or a
        cloud-reselection flag -- in which case all state (including the RNG
        key) is rolled back and the caller replays the segment through the
        boundary-chunked path, which handles events exactly as before.
        RNG: the scheduled reopts' extra-point keys are pre-split with
        `_split_chain` in the same order the host loop would consume them,
        so fused and replayed trajectories share one stream."""
        import time as _time

        cfg = self.cfg
        t0 = _time.perf_counter()
        opt = self.optimizer
        rf = cfg.reopt_freq
        n_periods = n // rf
        snap = (self.density, self.extra, self.gps, self.key,
                opt.diag_lengths, opt.off_params, opt.diag_magnitudes,
                opt.off_magnitude, dict(self._fit_ref), self.opt_result)
        ticks = np.arange(start_tick, start_tick + n)
        reopt_mask = ticks % rf == 0
        # drift-check cadence of the chunked path: chunk ends (tick+1 is a
        # boundary) and non-reopt boundaries
        in_b = (ticks % cfg.output_freq == 0) | reopt_mask
        next_in_b = ((ticks + 1) % cfg.output_freq == 0) | ((ticks + 1) % rf == 0)
        check_mask = next_in_b | (in_b & ~reopt_mask)
        check_mask &= ~reopt_mask  # the scan reopts there unconditionally
        active = np.asarray(self.density.active)
        act_idx = np.nonzero(active)[0]
        count = n_periods * len(act_idx)
        keys_seq = jnp.zeros((n_periods, NUM_ELEMENTS, 2), dtype=jnp.uint32)
        if count:
            self.key, subs = _split_chain(self.key, count)
            keys_seq = keys_seq.at[:, act_idx, :].set(
                subs.reshape(n_periods, len(act_idx), 2)
            )
        diag_params, off_params = opt.fitted_params()
        ref = self._fit_ref
        carry, stacks = _ticks_scan_fused(
            cfg.model, cfg.mass, cfg.dt, n_periods, rf,
            cfg.evolve_cutoff, self._track_moments, self._coh_k,
            cfg.num_extra_points, self._coh_div_eff,
            cfg.purity_target == "measured", bool(cfg.pop_rescale),
            self.density, self.extra, self.gps, diag_params, off_params,
            jnp.asarray(check_mask.reshape(n_periods, rf)), keys_seq,
            jnp.asarray(ref["pop"]), jnp.asarray(ref["pur"]),
            jnp.asarray(ref["target"]),
            jnp.asarray(purity_factor(cfg.dim) * self.purity_ratio),
            jnp.asarray(self.purity),
            jnp.asarray(getattr(self, "_pop_sum0", 0.0)),
            self._block_diag(),
        )
        density, extra, gps, dp, op, fpop, fpur, ftgt = carry
        # ONE blocking pull for the whole segment
        host, fpop, fpur, ftgt, dpn, opn = jax.device_get(
            (stacks, fpop, fpur, ftgt, dp, op)
        )
        # flatten (n_periods, reopt_freq, ...) stacks to per-tick arrays and
        # splice the post-reopt observables into each period's final tick
        host["small"] = host["small"].reshape(n, NUM_ELEMENTS)
        host["drift"] = host["drift"].reshape(n)
        obs = {k: np.array(v.reshape((n,) + v.shape[2:]))
               for k, v in host["obs"].items()}
        for k, v in host["obs_last"].items():
            obs[k][rf - 1::rf] = v
        host["obs"] = obs
        event = ((~host["small"]) != active[None, :]).any(axis=1)
        event |= host["drift"]
        if cfg.track_clouds:
            # re-selection flags fire at period-end (scheduled reopt) ticks
            resel_ticks = np.zeros(n, dtype=bool)
            resel_ticks[rf - 1::rf] = host["resel"]
            event |= resel_ticks
        if event.any():
            (self.density, self.extra, self.gps, self.key,
             opt.diag_lengths, opt.off_params, opt.diag_magnitudes,
             opt.off_magnitude, self._fit_ref, self.opt_result) = snap
            self.phase_times["fused_abort"] += _time.perf_counter() - t0
            # report the first event tick so the caller replays only up to
            # it before retrying fusion (instead of re-aborting repeatedly)
            return False, int(ticks[np.argmax(event)])
        self.density, self.extra, self.gps = density, extra, gps
        # sync the host optimizer state to the last in-graph reopt
        opt.diag_lengths = np.asarray(dpn.lengths)
        opt.diag_magnitudes = np.asarray(dpn.magnitude)
        opt.off_params = np.concatenate([
            [opn.real_magnitude], opn.real_lengths, [opn.imag_magnitude],
            opn.imag_lengths, [opn.corr],
        ])
        opt.off_magnitude = float(opn.magnitude)
        self._fit_ref = {"pop": float(fpop), "pur": float(fpur),
                         "target": float(ftgt)}
        if cfg.pop_rescale:
            # applied in-graph rescales count toward the same stat as the
            # host path's, so fused runs do not under-report
            applied = int(np.sum(np.abs(host["pop_s"] - 1.0) > 1e-6))
            if applied:
                self.stats["pop_rescales"] = (
                    self.stats.get("pop_rescales", 0) + applied)
        if n_periods:
            self.opt_result = OptResult(
                error=float(host["err"][-1]),
                steps=[opt.lbfgs_steps], opt_type="moment",
            )
        self.phase_times["fused"] += _time.perf_counter() - t0
        # emit the output frames from the stacked observables
        stopped = False
        t1 = _time.perf_counter()
        for i in np.nonzero(ticks % cfg.output_freq == 0)[0]:
            obs_i = {k: v[i] for k, v in host["obs"].items()}
            opt_type = "moment" if reopt_mask[i] else "none"
            rec = self._record_from_obs(int(ticks[i]), obs_i, opt_type)
            if callback is not None:
                callback(rec)
            if rec.x_average > -cfg.x0:
                self._log("wavepacket has left the interaction region")
                stopped = True
                break
        self.phase_times["output"] += _time.perf_counter() - t1
        return True, stopped

    # -- observation / output ---------------------------------------------------------
    def observe(self, tick: int, opt_type: str) -> TickRecord:
        cfg = self.cfg
        density, gps = self.density, self.gps
        # one fused dispatch for every scalar: one host round-trip per frame
        obs = jax.device_get(_observe_all(cfg.model, density, gps, cfg.mass))
        return self._record_from_obs(tick, obs, opt_type)

    def _record_from_obs(self, tick: int, obs, opt_type: str) -> TickRecord:
        cfg = self.cfg
        ppl_prm = obs["ppl_prm_each"]
        ppl_prm = ppl_prm / max(ppl_prm.sum(), 1e-30)
        rec = TickRecord(
            time=tick * cfg.dt,
            population_prm=float(obs["pop_prm"]),
            population_prm_each=ppl_prm,
            population_mci=obs["ppl_mci"],
            energy_prm=float(obs["energy_prm"]),
            energy_mci=float(obs["energy_mci"]),
            purity_prm=float(obs["purity_prm"]),
            purity_mci=float(obs["purity_mci_raw"])
            * purity_factor(cfg.dim) * self.purity_ratio,
            x_average=float(obs["x_average"]),
            opt_type=opt_type,
        )
        self.history.append(rec)
        if self.writers:
            self._write_outputs(rec, jnp.asarray(obs["energies"]))
        self._log(
            f"t={rec.time:8.2f} pop={rec.population_prm:.4f} "
            f"E={rec.energy_prm:.6f} purity={rec.purity_prm:.4f} "
            f"<x>={rec.x_average:8.3f} ppl={np.asarray(obs['ppl_mci']).round(4)} "
            f"opt={opt_type}"
        )
        return rec

    def _write_outputs(self, rec: TickRecord, energies):
        cfg = self.cfg
        density, gps = self.density, self.gps
        pops_prm = np.asarray(gps.population_each())
        surface_rows = []
        for s, k in enumerate(DIAG_INDICES):
            r_prm = np.asarray(RK.r_average(jax.tree.map(lambda a: a[s], gps.diag)))
            r_mci = np.asarray(
                OBS.r_average_one_element(density.points[k], density.rho[k])
            )
            surface_rows.append(
                (pops_prm[s], r_prm, rec.population_mci[s], r_mci, float(energies[s]))
            )
        r_all_prm = np.asarray(gps.r_average())
        r_all_mci = np.asarray(OBS.r_average_all_surfaces(density))
        totals = [
            rec.population_prm, *(r_all_prm / max(rec.population_prm, 1e-300)),
            rec.energy_prm / max(rec.population_prm, 1e-300),
            rec.population_mci.sum(), *r_all_mci, rec.energy_mci,
        ]
        pur_prm_diag = np.asarray(jax.vmap(RK.purity)(gps.diag))
        pur_off = float(CK.purity_complex(gps.offdiag)) if bool(gps.active[1]) else 0.0
        purity_prm = np.array(
            [[pur_prm_diag[0], pur_off], [pur_off, pur_prm_diag[1]]]
        )
        purity_mci = np.asarray(OBS.purity_each_element(density)) * purity_factor(cfg.dim)
        self.writers.write_average(surface_rows, totals, purity_prm, purity_mci)
        # param.txt
        triples = []
        diag_params, off_params = self.optimizer.fitted_params()
        for s, k in enumerate(DIAG_INDICES):
            lb, ub = Optimizer.length_bounds(np.asarray(density.points[k]))
            params = np.concatenate(
                [[float(diag_params.magnitude[s])], np.asarray(diag_params.lengths[s]), [1e-2]]
            )
            triples.insert(s * 2, ([1.0, *lb, 1e-2], params, [1.0, *ub, 1e-2]))
        olb, oub = Optimizer.length_bounds(np.asarray(density.points[OFFDIAG_INDEX]))
        off_flat = np.asarray(self.optimizer.off_params)
        triples.insert(
            1,
            (
                [1.0, 0.1, *olb, 0.1, *olb, -0.99, 1e-2],
                np.concatenate(
                    [[float(off_params.magnitude)], off_flat[:-1],
                     [off_flat[-1]], [1e-2]]
                ),
                [1.0, 10.0, *oub, 10.0, *oub, 0.99, 1e-2],
            ),
        )
        self.writers.write_param(triples)
        self.writers.write_points(
            np.asarray(density.points), density.rho_complex,
            np.asarray(self.extra.points), self.extra.rho_complex,
        )
        preds, variances = _grid_predictions(cfg.model, gps, self._grid)
        preds_c = np.asarray(preds)
        self.writers.write_phase(
            preds_c[..., 0] + 1.0j * preds_c[..., 1], np.asarray(variances)
        )
        # per-element label rescale factors in triangular order (00), (10), (11);
        # NaN for absent elements like the reference (output.cpp:264-292)
        diag_rescale = np.asarray(gps.diag.rescale)
        active = np.asarray(gps.active)
        rescales = np.where(
            active,
            [diag_rescale[0], float(gps.offdiag.rescale), diag_rescale[1]],
            np.nan,
        )
        opt_steps = getattr(self.opt_result, "steps", [])
        self.writers.write_log(
            rec.time, getattr(self.opt_result, "error", 0.0),
            [p.num_steps for p in self.mc_params],
            [p.displacement for p in self.mc_params],
            rec.opt_type,
            rescales=rescales,
            opt_steps=sum(opt_steps) if isinstance(opt_steps, (list, tuple)) else opt_steps,
        )

    # -- full run (main.cpp:132-202) ----------------------------------------------------
    def run(self, max_ticks: Optional[int] = None,
            callback: Optional[Callable] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0,
            resume_from: Optional[str] = None) -> List[TickRecord]:
        from gple_tpu.io import checkpoint as ckpt

        cfg = self.cfg
        if self.profile_dir:
            jax.profiler.start_trace(self.profile_dir)
        if resume_from:
            start_tick = ckpt.load_checkpoint(resume_from, self) + 1
            self._log(f"resumed from {resume_from} at tick {start_tick}")
        else:
            import time as _time

            t0 = _time.perf_counter()
            init_ck = self._init_cache_path() if cfg.init_cache else None
            if init_ck and __import__("os").path.exists(init_ck):
                ckpt.load_checkpoint(init_ck, self)
                self._log(f"init restored from cache {init_ck}")
            else:
                self.initialize()
                if init_ck:
                    ckpt.save_checkpoint(init_ck, self, 0)
            self.phase_times["init"] += _time.perf_counter() - t0
            t0 = _time.perf_counter()
            self.observe(0, self.opt_result.opt_type)
            self.phase_times["output"] += _time.perf_counter() - t0
            start_tick = 1
        total = cfg.total_ticks if max_ticks is None else min(cfg.total_ticks, max_ticks)

        def next_multiple(t: int, k: int) -> int:
            return ((t + k - 1) // k) * k if k else total

        # whole-segment fusion (scheduled reopts in-graph) applies to the
        # moment optimizer without writers/checkpoints; events fall back to
        # the boundary-chunked path below
        use_fused = (
            cfg.opt_mode == "moment"
            and cfg.fused_chunk > 0
            and self.writers is None
            and not (checkpoint_path and checkpoint_every)
            # the in-graph fused reopt does not implement the coherence
            # purity rescale -- fall back to the chunked path so the flag's
            # physics actually applies (see GPLEConfig.coh_boost_rescale)
            and not cfg.coh_boost_rescale
        )
        # fused segments are whole reopt periods (the scan reopts
        # unconditionally at each period end), so they must start right
        # after a scheduled reopt tick
        n_fused = max(1, cfg.fused_chunk // cfg.reopt_freq) * cfg.reopt_freq
        # abort hysteresis: an aborted segment's device work is wasted (on
        # an event-heavy run most of it was), so after an abort probe with
        # ONE-period segments and only return to full length after two
        # clean ones.  Exactly two segment lengths total -- every distinct
        # length is its own XLA program and its own compile.
        seg_len = n_fused
        clean_streak = 0
        # event hints from a previous run of this exact config (deterministic
        # under the init cache): pre-block fusion around recorded event ticks
        # instead of paying full-segment aborts (see _event_hints_path)
        hints_path = None
        event_hints = set()
        if cfg.init_cache and not resume_from:
            import json as _json
            import os as _os

            hints_path = self._event_hints_path()
            if _os.path.exists(hints_path):
                try:
                    event_hints = set(_json.load(open(hints_path)))
                    self._log(f"fusion event hints: {sorted(event_hints)}")
                except Exception:
                    event_hints = set()
        try:
            tick = start_tick
            fused_block_until = 0  # replay the chunked path through an event
            while tick <= total:
                if (use_fused and tick > fused_block_until
                        and (tick - 1) % cfg.reopt_freq == 0
                        and tick + seg_len - 1 <= total):
                    hinted = [h for h in event_hints
                              if tick <= h < tick + seg_len]
                    if hinted:
                        # a recorded event falls inside this would-be
                        # segment: replay the chunked path through it (no
                        # dispatch wasted, hysteresis untouched)
                        fused_block_until = min(hinted)
                    else:
                        ok, res = self._advance_fused(tick, seg_len, callback)
                        if ok:
                            tick += seg_len
                            clean_streak += 1
                            if clean_streak >= 2:
                                seg_len = n_fused
                            if res:  # stop condition hit inside the segment
                                break
                            continue
                        fused_block_until = res
                        self._event_ticks.add(res)
                        seg_len = cfg.reopt_freq
                        clean_streak = 0
                # the next tick where the host must intervene: scheduled
                # reopt, output, or checkpoint; everything before it is pure
                # device work and runs as one scanned chunk
                boundary = min(
                    next_multiple(tick, cfg.reopt_freq),
                    next_multiple(tick, cfg.output_freq),
                    next_multiple(tick, checkpoint_every)
                    if (checkpoint_path and checkpoint_every) else total,
                    total,
                )
                n_pre = boundary - tick
                # only scan the steady-state chunk length: every DISTINCT
                # n_pre is its own XLA program and its own compile (fused-
                # segment realignment produced irregular lengths); odd
                # remainders replay tick-by-tick
                canonical = n_pre == min(cfg.output_freq, cfg.reopt_freq) - 1
                if n_pre > 0 and canonical and self._advance_chunk(n_pre):
                    tick = boundary
                else:
                    # element changed mid-chunk (or nothing to chunk):
                    # tick-by-tick replay up to the boundary
                    for t in range(tick, boundary):
                        self.step(t)
                    tick = boundary
                opt_type = self.step(tick)
                if checkpoint_path and checkpoint_every and tick % checkpoint_every == 0:
                    ckpt.save_checkpoint(checkpoint_path, self, tick)
                if tick % cfg.output_freq == 0:
                    import time as _time

                    t0 = _time.perf_counter()
                    rec = self.observe(tick, opt_type)
                    self.phase_times["output"] += _time.perf_counter() - t0
                    if callback is not None:
                        callback(rec)
                    if rec.x_average > -cfg.x0:
                        self._log("wavepacket has left the interaction region")
                        break
                tick += 1
        finally:
            if self.profile_dir:
                jax.profiler.stop_trace()
            if hints_path and self._event_ticks:
                import json as _json

                try:
                    with open(hints_path, "w") as fh:
                        _json.dump(sorted({int(t) for t in
                                           event_hints | self._event_ticks}), fh)
                except OSError:
                    pass
        self._log(f"phase wall times: {self.phase_times}")
        if self.writers:
            self.writers.close()
        return self.history
