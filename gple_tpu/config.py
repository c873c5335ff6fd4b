"""Declarative runtime configuration.

The reference scatters its configuration between an 8-field text file named
``input`` (parsed at ``gaussian_process_liouville_equation/input.cpp:126-148``)
and compile-time constants (model selection ``pes.h:38-41``, boundary condition
``schrodinger_equation/general.h:95-97``, NumPES/Dim ``stdafx.h:111-119``).
Here everything is one dataclass, constructible either directly or from the
reference's ``input`` file format for drop-in compatibility.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from gple_tpu.utils.constants import HBAR

#: The number of grids per dimension for phase-space output
#: (reference ``input.cpp:9`` MaximumGridsForOneDimension).
MAX_GRIDS_PER_DIM = 200


@dataclasses.dataclass(frozen=True)
class GPLEConfig:
    """Full configuration of a GPR-MQCLE run (reference ``input.h:10-168``)."""

    # physics
    model: str = "DAC"          # compile-time TestModel in the reference
    num_pes: int = 2
    dim: int = 1
    mass: float = 2000.0
    x0: float = -10.0
    p0: float = 30.0
    sigma_p0: float = 1.5       # sigma_x0 = hbar / (2 sigma_p0)
    # numerics
    output_time: float = 1.0
    reopt_time: float = 1.0
    dt: float = 0.1
    num_points: int = 128       # training points per density-matrix element
    extra_point_factor: int = 5  # reference main.cpp:35
    dtype: str = "float64"
    # initial electronic state (reference main.cpp:38-39)
    initial_population: Tuple[float, float] = (1.0, 0.0)
    initial_phase_factor: Tuple[float, float] = (0.0, 0.0)
    seed: int = 0
    #: L-BFGS steps per stage: the initial cold fit and the warm-started
    #: in-trajectory re-optimizations (the latter start near the optimum, so
    #: half the steps reach the same loss in half the wall time)
    opt_steps_initial: int = 60
    opt_steps_reopt: int = 30
    #: Apply the 1-2 sigma smoothstep cutoff to GP predictions INSIDE the
    #: evolution loop (the reference does, main.cpp:75-101).  Off by default:
    #: the cutoff zeroes the spatial tails of the coherence every tick, a
    #: measured ~1-2%/tick leak that saturates Tully-A population transfer at
    #: ~1/30 of the exact value; without it the transfer tracks the exact
    #: grid-MQCLE solution.  The cutoff still guards element activation
    #: (is_very_small) and the output grids.  "coh" cutoffs ONLY the
    #: coherence's queries: the booster-stabilization channel fix -- a
    #: near-interpolating (div >= 4) coherence fit extrapolates noise
    #: between samples, which the diagonals read at their branch points
    #: through the off-diagonal rotation (the isolated divergence channel,
    #: benchmarks/boost_probe.py); the smoothstep suppresses exactly that
    #: low-signal/high-variance region while the diagonals keep the
    #: leak-free raw mean.
    evolve_cutoff: "bool | str" = False
    #: Purity target of the constrained re-optimizations: "measured" pins the
    #: GP-integral purity to the CURRENT Monte-Carlo point-sum purity (a fit-
    #: fidelity constraint); "initial" pins it to the t=0 purity like the
    #: reference (opt.cpp:1019, main.cpp:65).  "initial" actively distorts the
    #: coherence fit whenever the point dynamics is imperfect: early in the
    #: crossing it pumps the coherence to fill the purity budget, later it
    #: clips the growing coherence back (both observed on Tully A).
    purity_target: str = "measured"
    #: Re-run the Metropolis displacement/autocorrelation tuning on every
    #: drift-triggered cloud re-selection, like the reference re-tunes on
    #: every ``monte_carlo_selection`` (mc.cpp:339-374).  A/B on the crossing
    #: config (SAC x0=-2 p0=20 N=64, 240 ticks, same seed, 2026-08-17):
    #: RMSE 0.051 -> 0.0355 -- the re-selection walk samples the transferred
    #: density correctly only with a freshly tuned displacement.  The tuning
    #: sweeps (~2000 chain steps through the backward-branching predictor per
    #: re-selection) are batched scans; the measured wall cost is a few
    #: seconds per re-selection.  "auto" probes the current displacement
    #: with a 100-step chain first and runs the full sweeps only when its
    #: acceptance left the tuning window -- same accuracy mechanism (the
    #: transferred-density case that made re-tuning matter shows up as an
    #: off-window acceptance), a fraction of the cost when the cloud is
    #: stable (sampler/mc.py element_monte_carlo).
    mc_retune: "bool | str" = True
    #: Drift-triggered cloud re-selection (driver._track_clouds): walk an
    #: element's points to its current predicted density when the
    #: |rho|-weighted label mean drifts off the cloud mean.  Re-selection
    #: re-labels the walked points from the backward-branching predictor --
    #: a smoothing event for the coherence; disable to measure its cost in
    #: the carried-label feedback loop.
    track_clouds: bool = True
    #: Hyperparameter strategy per (re)optimization: "moment" sets moment-
    #: based parameters directly (|label|-weighted cloud std / 2, corr = 0,
    #: analytic magnitudes, no search); "ladder" runs the reference-style
    #: constrained restart ladder (opt.cpp:1019-1392).  Full-trajectory
    #: head-to-head (SAC x0=-4 p0=20 N=256 dt=1, same seed, 2026-08-18,
    #: benchmarks/parity.py): moment RMSE 0.0385 @ 1038 s vs ladder 0.0390
    #: @ 5501 s -- equal accuracy at 5.3x less wall.  On the 240-tick
    #: crossing segment alone the gap widens to 0.0188 vs 0.0355
    #: (benchmarks/moment_opt_ab.py): the constraints pin GP totals at the
    #: expense of the lengthscales the evolution reads.
    opt_mode: str = "moment"
    #: With ``opt_mode="moment"``: recompute the moment-based kernel
    #: parameters from the moved cloud INSIDE every fused tick (closed-form,
    #: jittable -- gp/opt.py:moment_kernel_params) instead of freezing them
    #: between reoptimizations.  Measured WORSE on the SAC crossing config
    #: (RMSE 0.067 vs 0.049 frozen, x0=-2 N=64 dt=1, 2026-08-17): lengths
    #: that track the cloud every tick co-evolve with the carried-label rot
    #: and amplify the fit-evolve feedback, while parameters frozen at the
    #: last reoptimization act as a stabilizer.  "off" tracks ONLY the
    #: coherence lengths per tick (its cloud std moves fast through the
    #: crossing while the fringe fit needs a tight std/len ratio; the
    #: round-2 "worse" measurement was the diagonal tracking at div 2).
    #: Ignored under ``opt_mode="ladder"``.
    moment_per_tick: "bool | str" = False
    #: Asymmetric coherence point budget: include this many of the
    #: off-diagonal element's EXTRA points (which evolve every tick with
    #: carried labels, exactly like the main cloud) in the coherence FIT.
    #: The coherence fit is the measured accuracy bottleneck (carried-label
    #: channel 0.0514 vs 0.0073 for diagonals at N = 64; scaling the
    #: coherence cloud 64 -> 256 measured 0.0514 -> 0.0346,
    #: docs/DESIGN.md round-3 decomposition) while the diagonal fits are
    #: essentially exact at any N -- so the extra resolution goes where the
    #: error lives.  0 disables; capped at ``num_extra_points``.
    coh_fit_extra: int = 0
    #: Moment-mode coherence lengthscale divisor (off lengths = weighted
    #: cloud std / coh_len_div).  Raise together with ``coh_fit_extra``:
    #: shorter lengths only pay off with the point support to back them
    #: (measured: n=256/div 6 -> carried-label RMSE 0.0130, at the
    #: ideal-label bound; div 6 at n=64 is a dead end -- gp/opt.py
    #: Optimizer.off_len_div).
    coh_len_div: float = 2.0
    #: Scalar purity-conservation rescale of the coherence labels (main
    #: cloud + carried booster slots) at every host reoptimization: shrink
    #: all off-diagonal labels by one factor s <= 1 so the MC purity never
    #: exceeds the run's initial purity.  The carried-booster feedback loop
    #: (labels -> fit -> backward prediction -> labels) has positive gain at
    #: coh_len_div >= 4 and blows up purity after ~15 reopt periods
    #: (measured on the CPU: purity 1.05 at t=320 -> 2.2 by t=360 at N=256,
    #: while the windowed RMSE before onset was 0.0017 vs 0.0106
    #: unboosted); one scalar per reopt
    #: clamps the loop gain without touching the fringe STRUCTURE the
    #: booster carries.  The reference applies the same conservation-rescale
    #: move to population+energy (test/gpr.cpp:913-992).  Forces the
    #: boundary-chunked path (the in-graph fused reopt does not implement
    #: the rescale).
    coh_boost_rescale: bool = False
    #: Scalar population-conservation rescale of the DIAGONAL labels at
    #: every reoptimization: multiply both diagonals' Re labels by one factor
    #: s = (initial total diagonal sum) / (current total diagonal sum), so
    #: the total population numerator -- the one diagonal point-sum that IS a
    #: trajectory-ensemble invariant (per-surface sums move with transfer;
    #: their total cannot) -- stays pinned across the trajectory.  The
    #: reference enforces exactly this at every reoptimization via its
    #: population equality constraint (opt.cpp:644-719); moment mode had no
    #: equivalent, and the div-6 booster runs showed the consequence: the
    #: diagonal labels inflate through evolution queries against the spiky
    #: coherence fit (GP population integral 1.018 by t=330, MC purity 1.30
    #: by t=350 with the coherence clamp active).  Factors outside [0.5, 2]
    #: mean the measurement itself is corrupt and are skipped.  Implemented
    #: identically in the host reopt (_reoptimize) and the fused in-graph
    #: reopt (_ticks_scan_fused), so it does not force the chunked path.
    #: DEFAULT OFF: flipped on in round 4 on unit-test evidence only, the
    #: full-protocol measurement then showed the default-on stack WORSE at
    #: production configs (SAC N=256 warm mci 0.098 vs the round-3 0.068,
    #: N=1024 population drifting to 2.18 with pop_rescales firing 9-14x)
    #: and the pinned crossing regression red (0.0602 vs <0.055,
    #: tests/test_crossing.py).  Remains available for booster configs where
    #: the diagonal-label inflation it clamps actually occurs.
    pop_rescale: bool = False
    #: Coherence fit-health backoff: when, at a reoptimization, the fitted
    #: GP's analytic purity integral exceeds this multiple of the purity
    #: target, the coherence lengthscale divisor is STICKILY halved (floor
    #: 2.0 = the smooth round-2 behavior) and the reopt re-runs.  Mechanism:
    #: the coherence fringes sharpen with time (k ~ t dp/hbar, DESIGN.md
    #: reading 4), so any fixed short lengthscale eventually goes
    #: near-interpolating on unresolvable structure -- the labels stay
    #: bounded (coh_boost_rescale clamps them) but alpha and the purity
    #: QUADRATIC explode (measured: purity_prm 1.01 -> 6.7 post-crossing at
    #: div 6 while the MC purity stayed clamped).  The backoff keeps the div-6
    #: resolution through the crossing window (where its 6x accuracy gain
    #: lives) and degrades gracefully after, the same escalation shape as
    #: the reference's check_averages restart ladder (opt.cpp:1200-1392).
    #: If the fit is STILL detached at the div-2 floor, the carried booster
    #: is ejected outright (coh_k -> 0): the run returns to the stable
    #: main-cloud-only fit (measured: at div 2 with the booster still in
    #: the fit the purity integral kept running away, 2.3 -> 3.4).
    #: 0 disables the check.
    coh_fit_health_factor: float = 1.5
    #: Conservation-preserving relabel: after a cloud re-selection walks and
    #: relabels an element's points, rescale the new labels by one scalar so
    #: the element's MC-integral estimator is CONTINUOUS across the event
    #: (diagonals: sum of Re rho; coherence: sum of |rho|^2, with the carried
    #: booster scaled by the same factor).  A re-selection only re-samples
    #: the field -- the physical population/purity cannot jump in one tick --
    #: but the point-sum estimators are trajectory-ensemble invariants whose
    #: normalization a fresh Metropolis sample does NOT reproduce: the
    #: round-3 div-6 booster run diverged exactly at the first reselection
    #: relabel (purity 5.9, diagonal populations 1.24).  The reference
    #: prevents the same jump by re-optimizing with population/purity pinned
    #: as equality constraints right after its mid-run seeding
    #: (opt.cpp:644-719 via main.cpp:145-163); this scalar is the moment-mode
    #: equivalent.  A relabel whose raw integral is wildly off (factor > 5 or
    #: sign flip) is REJECTED: the element keeps its previous points+labels
    #: (failure containment in the spirit of the reference's make_normal /
    #: try-catch fallbacks, opt.cpp:418-431).
    #: DEFAULT OFF: turning this on by default was the round-4 regression --
    #: the bisect pinned the crossing-test red (RMSE 0.055 -> 0.0602) to
    #: exactly this flip (commit 36d6b90), and the round-4 on-chip protocol
    #: measured the default-on stack worse than round 3 at every production
    #: config.  At default (no booster, coh_len_div = 2)
    #: the relabel queries are smooth and the continuity pin only fights the
    #: legitimate population transfer the re-selection is sampling.  Keep it
    #: for div>=4 booster configs, whose near-interpolating relabel queries
    #: it was built to contain.
    relabel_conserve: bool = False
    #: During re-selection relabeling of a DIAGONAL element, mask the
    #: coherence's contribution out of the backward-branching predictor (the
    #: relabel query walks through the off-diagonal rotation, so a spiky
    #: boosted coherence fit pollutes the fresh diagonal labels -- the
    #: isolated mechanism of the round-3 booster divergence,
    #: docs/DESIGN.md).  The diagonal's own GP already carries the
    #: transferred population; masking drops only the one-tick coherence
    #: correction from the relabel query.
    relabel_mask_coh: bool = False
    #: Drift re-selection of the COHERENCE cloud itself.  False freezes the
    #: off-diagonal element out of driver._track_clouds while the carried
    #: booster is alive: its points already follow the mean-surface
    #: characteristics through the coupling window and its labels are
    #: carried, so a mid-crossing Metropolis re-walk only re-labels a
    #: resolved fringe field through a GP query -- the decompose harness
    #: (benchmarks/decompose.py --gp off --labels carried, n=256/div 6,
    #: RMSE 0.0130 over the full transfer window) runs exactly this
    #: no-reselection structure and is stable where production diverges
    #: (purity jump at the first (1,0) reselection, t=310).  Diagonal
    #: re-selections are unaffected --
    #: they are what tracking is actually for (the transferred mass's
    #: momentum jump has no trajectory counterpart).  Ignored (reselection
    #: stays on) when coh_fit_extra == 0.
    coh_reselect: bool = True
    #: Fused-segment length: advance this many ticks -- including the
    #: scheduled closed-form (moment) reoptimizations and the per-frame
    #: observables -- in ONE jitted scan dispatch, syncing with the host once
    #: per segment, so blocking host round-trips do not sit between ticks.
    #: Whether this still pays against the chunked path on a local GPU is
    #: not measured yet.  Rare events (element activation, conservation
    #: drift, cloud re-selection) roll the segment back and replay it through
    #: the boundary-chunked path.  0 disables; only the moment optimizer
    #: without writers/checkpoints is eligible (driver.run).
    fused_chunk: int = 100
    #: Metropolis WALK surrogate for re-selection / new-element seeding: the
    #: chains' stationary target is a 256^2 grid sample of the backward-
    #: branching predictor (one batched call) interpolated bilinearly,
    #: instead of the full predictor per step.  Labels and candidate scoring
    #: stay EXACT (reference semantics, mc.cpp:497-517) -- only point
    #: PLACEMENT uses the surrogate.  A full-predictor chain step is a
    #: long chain of small kernels, so a walk of many steps is launch-bound
    #: (per-walk timing: GPLE_MC_TIMING=1).  Only takes effect for 2D phase
    #: spaces; False restores exact walks.
    mc_walk_surrogate: bool = True
    #: Cache the INITIALIZATION state (Metropolis-selected seed cloud, tuned
    #: MC parameters, first fit, conserved targets, post-init RNG key) on
    #: disk, keyed by every config field, and restore it on repeat runs of
    #: the same config.  Initialization is deterministic given the config
    #: seed, so a restored run is bitwise-identical to a cold one, and
    #: restoring skips the init walk's dispatches entirely.  The same move as
    #: the XLA compilation cache, applied to the one remaining cold-start
    #: phase.  Files live in ``<checkout>/.gple_state``.
    init_cache: bool = False
    #: Run-for-run comparable to the reference: forces ``evolve_cutoff=True``
    #: (main.cpp:75-101), ``purity_target="initial"`` (main.cpp:65), and pins
    #: the complex-kernel correlation at rho = 1 (complex_kernel.h:12-13)
    #: instead of learning it.  The measured-accuracy defaults above
    #: deliberately diverge from the reference; this preset restores its
    #: exact behavior for apples-to-apples validation runs.
    reference_parity: bool = False

    def __post_init__(self):
        if self.reference_parity:
            object.__setattr__(self, "evolve_cutoff", True)
            object.__setattr__(self, "purity_target", "initial")
            object.__setattr__(self, "mc_retune", True)
            object.__setattr__(self, "opt_mode", "ladder")

    # -- derived quantities (reference input.cpp:25-77) -----------------------
    @property
    def sigma_x0(self) -> float:
        return HBAR / (2.0 * self.sigma_p0)

    @property
    def r0(self) -> np.ndarray:
        return np.array([self.x0, self.p0])

    @property
    def sigma_r0(self) -> np.ndarray:
        return np.array([self.sigma_x0, self.sigma_p0])

    @property
    def xmin(self) -> float:
        return -2.0 * abs(self.x0)

    @property
    def xmax(self) -> float:
        return 2.0 * abs(self.x0)

    @property
    def num_grids_per_dim(self) -> int:
        # The reference computes max(200, span/dx_deBroglie) (input.cpp:39) but
        # documents the 200 as a CAP "to prevent too big output files"
        # (input.cpp:8-9); we honor the documented cap -- the grid only feeds
        # visualization output, and 879 grids/dim would make phase.txt huge.
        span = self.xmax - self.xmin
        min_dx = math.pi / 2.0 * HBAR / (self.p0 + 3.0 * self.sigma_p0)
        return min(MAX_GRIDS_PER_DIM, int(span / min_dx) + 1)

    @property
    def dx(self) -> float:
        return (self.xmax - self.xmin) / self.num_grids_per_dim

    @property
    def pmin(self) -> float:
        return self.p0 - math.pi / 2.0 * HBAR / self.dx

    @property
    def pmax(self) -> float:
        return self.p0 + math.pi / 2.0 * HBAR / self.dx

    @property
    def dp(self) -> float:
        return (self.pmax - self.pmin) / self.num_grids_per_dim

    @property
    def rmin(self) -> np.ndarray:
        return np.array([self.xmin, self.pmin])

    @property
    def rmax(self) -> np.ndarray:
        return np.array([self.xmax, self.pmax])

    @property
    def output_freq(self) -> int:
        return int(round(max(self.output_time, self.dt) / self.dt))

    @property
    def reopt_freq(self) -> int:
        return int(round(max(self.reopt_time, self.dt) / self.dt))

    @property
    def total_ticks(self) -> int:
        return int(2.0 * abs(2.0 * self.x0 * self.mass / self.p0) / self.dt)

    @property
    def num_extra_points(self) -> int:
        return self.num_points * self.extra_point_factor

    def phase_grids(self) -> np.ndarray:
        """The (n_grid_total, 2) output grid over phase space (input.cpp:49-71)."""
        n = self.num_grids_per_dim
        xs = self.xmin + self.dx * np.arange(n)
        ps = self.pmin + self.dp * np.arange(n)
        gx, gp = np.meshgrid(xs, ps, indexing="ij")
        return np.stack([gx.ravel(), gp.ravel()], axis=-1)

    # -- reference `input` file compatibility ---------------------------------
    @classmethod
    def from_input_file(cls, path: str, **overrides) -> "GPLEConfig":
        """Parse the reference's 8-field ``input`` format (input.cpp:84-148).

        Format: alternating description line / value line with fields
        mass, x0, p0, sigma_p0, output time, re-optimization time, dt, #points.
        """
        values = []
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        # every second line is a value (description lines come first)
        for i in range(1, len(lines), 2):
            values.append(lines[i].split()[0])
        if len(values) < 8:
            raise ValueError(f"input file {path!r} has {len(values)} fields; need 8")
        kw = dict(
            mass=float(values[0]),
            x0=float(values[1]),
            p0=float(values[2]),
            sigma_p0=float(values[3]),
            output_time=float(values[4]),
            reopt_time=float(values[5]),
            dt=float(values[6]),
            num_points=int(values[7]),
        )
        kw.update(overrides)
        return cls(**kw)
