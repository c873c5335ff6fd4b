"""What the GPU runs: every platform switch names a CUDA branch, the CUDA
branches work, and the step lowers for CUDA to a Cholesky refit with f64
predictions.

Lowering for CUDA needs no card (``jax.export`` with ``platforms=("cuda",)``),
so these run on the CPU."""

import ast
import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _platform_dependent_calls():
    for path in sorted(glob.glob(os.path.join(REPO, "gple_tpu", "**", "*.py"),
                                 recursive=True)):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "platform_dependent"):
                yield os.path.relpath(path, REPO), node


def test_every_platform_switch_names_cpu_and_cuda():
    calls = list(_platform_dependent_calls())
    assert calls, "no platform switch found"
    for path, node in calls:
        kws = {k.arg for k in node.keywords}
        assert {"cpu", "cuda"} <= kws, (path, node.lineno, kws)
        assert "default" not in kws, (path, node.lineno)


_TARGET = np.asarray([0.3, -0.7, 1.1])


def _loss(z):
    """Smooth, anisotropic, O(1)-scaled like the sigmoid-space GP losses."""
    d = z - _TARGET[: z.shape[0]]
    return jnp.sum(np.asarray([1.0, 4.0, 9.0])[: z.shape[0]] * d**2) \
        + 0.1 * jnp.sum(d**4)


@pytest.mark.parametrize("z0", [[0.0, 0.0], [1.0, 1.0, -1.0]])
def test_lbfgs_cuda_branch_matches_cpu_branch(z0):
    """The CUDA branch of the inner solver (fixed-fan linesearch), run here on
    the CPU, reaches the same minimum as the CPU branch (zoom linesearch)."""
    from gple_tpu.gp.opt import _lbfgs_fixed_fan, _lbfgs_zoom

    z0 = jnp.asarray(z0)
    target = np.asarray(_TARGET[: z0.shape[0]])
    z_cuda = np.asarray(jax.jit(lambda z: _lbfgs_fixed_fan(_loss, z, 60))(z0))
    z_cpu = np.asarray(jax.jit(lambda z: _lbfgs_zoom(_loss, z, 60))(z0))
    np.testing.assert_allclose(z_cpu, target, atol=1e-5)
    np.testing.assert_allclose(z_cuda, target, atol=1e-4)


def test_lbfgs_lowers_for_cuda():
    from gple_tpu.gp.opt import _lbfgs_scan

    fn = jax.jit(lambda z: _lbfgs_scan(_loss, z, 5))
    exp = jax.export.export(fn, platforms=("cuda",))(
        jax.ShapeDtypeStruct((2,), jnp.float64))
    assert exp.platforms == ("cuda",)


@pytest.fixture(scope="module")
def step_module_for_cuda():
    import __graft_entry__ as g
    from gple_tpu.parallel.sharding import make_step_fn

    density, gps = g._example_state(16)
    step = jax.jit(make_step_fn("SAC", 2000.0, 1.0))
    args = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        (density, gps))
    return jax.export.export(step, platforms=("cuda",))(*args).mlir_module()


def test_step_refit_lowers_to_cusolver_cholesky(step_module_for_cuda):
    targets = set(re.findall(r"custom_call @(\w+)", step_module_for_cuda))
    assert "cusolver_potrf_ffi" in targets, targets


def test_step_predicts_in_f64_on_cuda(step_module_for_cuda):
    """No f32 matmul anywhere in the CUDA step: predictions run in f64 (the
    f32 path measured slower on the H100, PERF.md)."""
    dots = re.findall(r"stablehlo\.dot_general.*", step_module_for_cuda)
    assert dots
    assert not [d for d in dots if "xf32>" in d]
