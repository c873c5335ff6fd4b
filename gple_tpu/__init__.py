"""gple_tpu: a JAX framework for Gaussian-process mixed quantum-classical
Liouville dynamics on the Tully scattering models, run on NVIDIA GPUs.

This is a ground-up re-design (not a port) of the capabilities of the reference
C++/Eigen/MKL code base ``kaigu1997/gaussian_process_liouville_equation``:

* :mod:`gple_tpu.models`    -- Tully SAC/DAC/ECR surfaces, adiabatic/force-basis
  transforms, Manolopoulos absorbing potential (reference ``*/pes.cpp``).
* :mod:`gple_tpu.oracles`   -- exact verification oracles: DVR Schroedinger solver
  (reference ``schrodinger_equation/``) and grid MQCLE Trotter solver
  (reference ``liouville_equation/``).
* :mod:`gple_tpu.ops`       -- batched real and complex Gaussian-process kernels
  (reference ``kernel.cpp``/``complex_kernel.cpp``) and the SPD linear algebra
  of the refits.
* :mod:`gple_tpu.gp`        -- constrained hyperparameter optimization (reference
  ``opt.cpp``) using jit-compiled gradient optimizers and autodiff.
* :mod:`gple_tpu.sampler`   -- Metropolis phase-space sampler with displacement and
  autocorrelation tuning (reference ``mc.cpp``), fully on-device under ``lax.scan``.
* :mod:`gple_tpu.dynamics`  -- the branching backward-prediction evolver (reference
  ``evolve.cpp``) as one batched pure function.
* :mod:`gple_tpu.driver`    -- the fit -> sample -> evolve -> refit orchestration
  loop (reference ``main.cpp``).
* :mod:`gple_tpu.parallel`  -- multi-chip sharding over a ``jax.sharding.Mesh``
  (new capability; the reference is single-process shared-memory only).

All compute-path code is pure-functional JAX: static shapes, ``vmap`` over points
and density-matrix elements, ``lax.scan`` over time, and batched f64 linear
algebra (cuSOLVER / cuBLAS on the GPU).
"""

import jax as _jax

# On an NVIDIA GPU the default f32 matmul may run in TF32 (~1e-3 relative
# rounding, about three decimal digits).  Reduced-precision passes were
# measured as a 0.8% population error per refit and per-tick noise on the
# control-variate branch differences; the conservation checks demand full
# f32/f64 semantics everywhere, so pin the matmul precision package-wide
# (no-op on CPU).
_jax.config.update("jax_default_matmul_precision", "highest")

from gple_tpu.utils.constants import HBAR, PLANCK_H

__version__ = "0.1.0"

__all__ = ["HBAR", "PLANCK_H", "__version__"]
