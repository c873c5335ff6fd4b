"""Metropolis phase-space sampler, fully batched on device.

Re-design of the reference sampler (``mc.cpp``):

* initial Gaussian phase-space distribution             -- ``mc.cpp:30-50``
* Metropolis Markov chains                              -- ``mc.cpp:143-188``
* displacement tuning over a log grid of 16 candidates  -- ``mc.cpp:288-331``
* autocorrelation-based step-count tuning               -- ``mc.cpp:197-279``
* extra-point jittering                                 -- ``mc.cpp:59-120``
* new-element point seeding                             -- ``mc.cpp:407-537``

Design notes:

* The reference walks each point's chain on its own thread; here ONE
  ``lax.scan`` advances ALL N walkers per step, so each step is a single
  batched distribution evaluation (a GP predict = matmul).
* Distribution functions are pure ``dist_fn(dist_params, pts)`` pairs -- the
  callable is static (compiled once per kind) while the parameters (GP state)
  flow through as a pytree, so refits never retrace.
* Displacement tuning evaluates all 16 candidate displacements in one vmapped
  sweep instead of sequential trial-and-error, then applies the reference's
  acceptance-window selection rule.
* Autocorrelation uses an FFT (O(L log L)) instead of the reference's O(L^2)
  double loop; the acceptance re-check of the reference's do/while re-uses the
  recorded acceptance mask (cumulative means) instead of running fresh chains,
  which is the same estimator in expectation without recompilation.
* Chosen step counts are rounded up to the next power of two so the jitted
  chain kernel compiles for a bounded set of lengths.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gple_tpu.utils import ri

#: Metropolis acceptance-ratio window (mc.cpp:19-21)
MAX_ACCEPT_RATIO = 0.5
MIN_ACCEPT_RATIO = 0.15
#: candidate maximum displacements (mc.cpp:298)
POSSIBLE_DISPLACEMENTS = (
    1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0,
)
#: choose the minimal step whose |autocorr| < factor * min|autocorr| (mc.h:55)
ABOVE_MIN_FACTOR = 1.1


@dataclasses.dataclass
class MCParameters:
    """Per-element tuned sampler parameters (reference mc.h:46-92)."""

    num_steps: int = 200
    displacement: float = 1.0


def initial_distribution(r0, sigma_r0, pts, row, col, populations, phase_factors):
    """Initial Gaussian phase-space density of element (row, col) at ``pts``
    (M, PhaseDim), returned as an RI array (M, 2) (reference mc.cpp:30-50)."""
    r0 = jnp.asarray(r0)
    sig = jnp.asarray(sigma_r0)
    dim = r0.shape[0] // 2
    gauss = jnp.exp(-0.5 * jnp.sum(((pts - r0) / sig) ** 2, axis=-1)) / (
        (2.0 * math.pi) ** dim * jnp.prod(sig)
    )
    pops = jnp.asarray(populations)
    phases = jnp.asarray(phase_factors)
    weight = pops[row] * pops[col] / jnp.sum(pops**2)
    return ri.phase_mul(ri.ri(gauss * weight), phases[row] - phases[col])


@partial(jax.jit, static_argnums=(1, 3, 5))
def markov_chain(key, dist_fn, dist_params, n_steps: int, pts, record: bool, displacement):
    """Advance all walkers ``n_steps`` Metropolis steps simultaneously.

    ``dist_fn(dist_params, pts (M, PhaseDim)) -> (M, 2) RI``.  Returns
    ``(final_pts, accept_mask (n_steps, M), chain or None)`` where ``chain`` is
    the recorded (n_steps + 1, M, PhaseDim) positions when ``record``.
    """
    w0 = ri.absval(dist_fn(dist_params, pts))

    def step(carry, key_step):
        cur, w_cur = carry
        k1, k2 = jax.random.split(key_step)
        prop = cur + jax.random.uniform(
            k1, cur.shape, dtype=cur.dtype, minval=-displacement, maxval=displacement
        )
        w_new = ri.absval(dist_fn(dist_params, prop))
        u = jax.random.uniform(k2, w_new.shape, dtype=w_new.dtype)
        accept = (w_new > w_cur) | (w_new > u * w_cur)
        nxt = jnp.where(accept[:, None], prop, cur)
        w_nxt = jnp.where(accept, w_new, w_cur)
        out = (nxt, accept) if record else accept
        return (nxt, w_nxt), out

    keys = jax.random.split(key, n_steps)
    (final, _), outs = jax.lax.scan(step, (pts, w0), keys)
    if record:
        chain_tail, accepts = outs
        chain = jnp.concatenate([pts[None], chain_tail], axis=0)
        return final, accepts, chain
    return final, outs, None


def _round_up_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@partial(jax.jit, static_argnums=(1,))
def _displacement_sweep(key, dist_fn, dist_params, pts):
    dim = pts.shape[-1]
    n_steps = dim * 500  # mc.cpp:297
    disps = jnp.asarray(POSSIBLE_DISPLACEMENTS)
    keys = jax.random.split(key, len(POSSIBLE_DISPLACEMENTS))

    def one(k, d):
        _, accepts, _ = markov_chain(k, dist_fn, dist_params, n_steps, pts, False, d)
        return jnp.mean(accepts)

    return jax.vmap(one)(keys, disps)


def tune_displacement(key, dist_fn, dist_params, pts) -> float:
    """Pick the largest displacement whose acceptance falls inside
    [0.15, 0.5]; all 16 candidates evaluated in one vmapped sweep
    (reference mc.cpp:288-331 walks them sequentially largest-first)."""
    accs = np.asarray(_displacement_sweep(key, dist_fn, dist_params, pts))
    ok = (accs > MIN_ACCEPT_RATIO) & (accs < MAX_ACCEPT_RATIO)
    for i in reversed(range(len(POSSIBLE_DISPLACEMENTS))):
        if ok[i]:
            return POSSIBLE_DISPLACEMENTS[i]
    # no candidate in window: fall back to the best-acceptance candidate
    return POSSIBLE_DISPLACEMENTS[int(np.argmin(np.abs(accs - 0.3)))]


@partial(jax.jit, static_argnums=(1,))
def _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement):
    """Run the long tuning chains; return (autocorr (L/2,), cum_acc (L,))."""
    dim = pts.shape[-1]
    max_steps = dim * 1000  # MaxNOMC, mc.cpp:206
    _, accepts, chain = markov_chain(
        key, dist_fn, dist_params, max_steps, pts, True, displacement
    )
    length = max_steps + 1
    half = length // 2
    centered = chain - jnp.mean(chain, axis=0, keepdims=True)  # (L, M, D)
    # FFT autocorrelation over the step axis: sum_i c_i . c_{i+j}
    # (f32: this is a tuning statistic, not an observable, and the step
    # count it picks is insensitive to f32 rounding)
    nfft = 2 * length
    f = jnp.fft.rfft(centered.astype(jnp.float32), n=nfft, axis=0)
    raw = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[:length].astype(
        chain.dtype
    )  # (L, M, D)
    raw = jnp.sum(raw, axis=-1)                                    # dot over dims
    denom = length - jnp.arange(length)
    ac = jnp.mean(raw, axis=1) / denom                             # avg over walkers
    cum_acc = jnp.cumsum(jnp.mean(accepts, axis=1)) / jnp.arange(1, max_steps + 1)
    return ac[:half], cum_acc


def tune_steps(key, dist_fn, dist_params, pts, displacement) -> int:
    """Autocorrelation-based step count (reference mc.cpp:197-279): smallest
    lag whose |autocorr| is within 1.1x of the minimum, subject to the
    acceptance window, rounded up to a power of two for compile reuse."""
    ac, cum_acc = _autocorrelation_sweep(key, dist_fn, dist_params, pts, displacement)
    ac = np.abs(np.asarray(ac))
    cum_acc = np.asarray(cum_acc)
    length = ac.shape[0]
    min_start, min_step, min_val = 0, 0, 0.0
    for _ in range(64):
        min_start = min_step + 1
        if min_start >= length:
            min_start = 1
            min_step = int(np.argmin(ac))
            min_val = ac[min_step]
            break
        rel = int(np.argmin(ac[min_start:]))
        min_step = min_start + rel
        min_val = ac[min_step]
        acc = cum_acc[min(min_step, cum_acc.shape[0]) - 1]
        if MIN_ACCEPT_RATIO < acc < MAX_ACCEPT_RATIO:
            break
    for i_step in range(min_start, min_step):
        if ac[i_step] <= ABOVE_MIN_FACTOR * min_val:
            min_step = i_step
            break
    return _round_up_pow2(max(1, min_step))


@partial(jax.jit, static_argnums=(1, 4))
def _probe_acceptance(key, dist_fn, dist_params, pts, n_steps, displacement):
    _, accepts, _ = markov_chain(
        key, dist_fn, dist_params, n_steps, pts, False, displacement
    )
    return jnp.mean(accepts)


def element_monte_carlo(
    key, dist_fn, dist_params, pts, params: MCParameters, tune=True, walk=None
) -> Tuple[jnp.ndarray, jnp.ndarray, MCParameters]:
    """Tune then walk all points of one element (reference mc.cpp:339-374).

    ``tune``: True runs the full displacement + autocorrelation tuning
    (reference behavior on every selection, mc.cpp:288-331); False reuses
    the stored parameters; "auto" probes the CURRENT displacement with a
    short chain and re-tunes only when its acceptance left the
    [MIN, MAX_ACCEPT_RATIO] window -- the full sweeps cost ~18k chain steps
    through the backward-branching predictor (~10 s per re-selection,
    the dominant optimize-phase term at N = 64), while a stable cloud's
    tuned displacement stays valid across re-selections.

    ``walk``: optional (walk_fn, walk_params) Metropolis TARGET used for the
    tuning sweeps and the chains instead of ``dist_fn``; the returned LABELS
    always come from the exact ``dist_fn`` (one batched call).  The driver
    passes a grid-sampled surrogate of the backward-branching predictor
    here: a chain step through the full predictor is ~100 small kernels
    (launch-bound), while the surrogate's bilinear interpolation is ~10
    kernels per step for the same stationary shape.

    Returns (new_points, new_rho, updated MCParameters).
    """
    import os
    import time as _time

    walk_fn, walk_params = walk if walk is not None else (dist_fn, dist_params)
    timing = os.environ.get("GPLE_MC_TIMING")
    marks = [("start", _time.perf_counter())]
    k0, k1, k2, k3 = jax.random.split(key, 4)
    if tune == "auto":
        acc = float(_probe_acceptance(
            k0, walk_fn, walk_params, pts, 100, params.displacement
        ))
        tune = not (MIN_ACCEPT_RATIO < acc < MAX_ACCEPT_RATIO)
        marks.append(("probe", _time.perf_counter()))
    if tune:
        params.displacement = tune_displacement(k1, walk_fn, walk_params, pts)
        marks.append(("disp", _time.perf_counter()))
        params.num_steps = tune_steps(k2, walk_fn, walk_params, pts, params.displacement)
        marks.append(("steps", _time.perf_counter()))
    final, _, _ = markov_chain(
        k3, walk_fn, walk_params, params.num_steps, pts, False, params.displacement
    )
    rho = dist_fn(dist_params, final)
    if timing:
        rho.block_until_ready()
    marks.append(("walk", _time.perf_counter()))
    if timing:
        print("    mc: " + ", ".join(
            f"{nm}={t1 - t0:.1f}s"
            for (nm, t1), (_, t0) in zip(marks[1:], marks[:-1])
        ), flush=True)
    return final, rho, params


@partial(jax.jit, static_argnums=(2, 3))
def generate_extra_points_element(key, pts, n_extra: int, dist_fn, dist_params):
    """Jitter existing points with per-dimension N(0, std) noise and label by
    the current distribution (reference mc.cpp:59-120)."""
    n = pts.shape[0]
    std = jnp.sqrt(
        jnp.maximum(jnp.mean(pts**2, axis=0) - jnp.mean(pts, axis=0) ** 2, 0.0)
    )
    base = pts[jnp.arange(n_extra) % n]
    noise = jax.random.normal(key, base.shape, dtype=base.dtype) * std
    new_pts = base + noise
    return new_pts, dist_fn(dist_params, new_pts)


def seed_new_element(key, candidate_pts, num_points: int, dist_fn, dist_params,
                     params: MCParameters, walk=None):
    """Seed a newly-populated element (reference mc.cpp:407-537): evaluate the
    predicted density at every existing coordinate, keep the ``num_points``
    with largest |rho| (zero-density picks are replaced by the best point),
    then random-walk them into place.

    ``walk``: optional (walk_fn, walk_params) Metropolis TARGET standing in
    for ``dist_fn`` during the chains only -- candidate scoring and the final
    labels always use the exact ``dist_fn`` (see element_monte_carlo)."""
    rho_all = dist_fn(dist_params, candidate_pts)
    score = ri.abs2(rho_all)
    top_score, top_idx = jax.lax.top_k(score, num_points)
    best = top_idx[0]
    chosen = jnp.where((top_score > 0.0)[:, None], candidate_pts[top_idx], candidate_pts[best])
    return element_monte_carlo(key, dist_fn, dist_params, chosen, params,
                               tune=True, walk=walk)
