"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices, so the multi-device
sharding paths are validated without a GPU; float64 is enabled to match the
reference's double-precision physics.  Tests marked ``gpu`` need an NVIDIA
card and skip elsewhere; on a machine with one, run them with
``python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import shutil  # noqa: E402
import subprocess  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def _has_gpu() -> bool:
    if shutil.which("nvidia-smi") is None:
        return False
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    return r.returncode == 0 and "GPU" in r.stdout


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests where there is no card (decided here, at
    run time, so every xdist worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") and not _has_gpu():
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none)")


@pytest.fixture(autouse=True, scope="module")
def _bound_executable_maps():
    """Drop live compiled executables when memory-mapping pressure builds.

    The full suite compiles hundreds of XLA:CPU programs into ONE process
    (x8 virtual devices); every live executable holds JIT code mappings, and
    the kernel caps a process at vm.max_map_count (65530 here) total
    mappings.  When mmap starts failing, LLVM's JIT segfaults inside
    ``backend_compile_and_load`` -- reproduced twice on 2026-08-20, always
    at a LATE big compile (test_sharding / test_entry_compiles at ~85%)
    while the same compile passes standalone.  Clearing jax's executable caches between modules
    unmaps dead programs; the persistent compilation cache makes the
    recompiles cheap loads."""
    yield
    try:
        with open("/proc/self/maps") as fh:
            n = sum(1 for _ in fh)
    except OSError:
        return
    if n > 35000:
        jax.clear_caches()
