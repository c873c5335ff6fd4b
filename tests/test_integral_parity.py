"""Cross-platform analytic-integral parity: the GPU fit against the CPU's
direct f64 Cholesky fit (the reference-equivalent path, kernel.cpp:281-283)
on THE SAME cloud and THE SAME hyperparameters.

The integral semantics under test are the reference's kernel.cpp:286-335
(population, <r>, purity) and complex_kernel.cpp:287-377 (coherence
purity).  The test harness pins jax to the CPU backend (conftest.py), so the
GPU leg runs phase e of ``chip_smoke.py`` in a child process that can see the
card; the tolerances are ``chip_smoke.FIT_TOL`` (1e-3 relative at the
production lengthscale divisor)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import jax
jax.config.update("jax_enable_x64", True)
import chip_smoke as cs
gpu = jax.devices()[0]
assert gpu.platform == "gpu", gpu.platform
result = {}
cs.phase_fit(result, gpu, jax.local_devices(backend="cpu")[0], n=%d)
print(result)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("n", [256, 1024])
def test_integrals_agree_cpu_vs_gpu(n):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", _CHILD % n], capture_output=True,
                       text=True, timeout=1800, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
