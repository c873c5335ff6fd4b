"""Placement of the persistent compile cache and the driver's state files."""

import os

import jax
import pytest

from gple_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_env_dir_is_used_verbatim(backend, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    got = cache.cache_settings(backend)["jax_compilation_cache_dir"]
    assert got == str(tmp_path)


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_default_dir_is_in_the_checkout(backend, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.cache_settings(backend)["jax_compilation_cache_dir"]
    base = os.path.join(REPO, ".jax_cache")
    if backend == "gpu":
        assert got == base
    else:  # per-host subdirectory: XLA:CPU entries bake in CPU features
        assert os.path.dirname(got) == base
        assert os.path.basename(got).startswith("cpu-")


def test_enable_sets_only_the_env_dir_on_gpu(monkeypatch, tmp_path):
    """On a GPU backend with the variable set, the one cache directory the
    code sets is exactly that directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.__setitem__(name, value))
    cache.enable_persistent_cache()
    dirs = {k: v for k, v in seen.items() if "dir" in k}
    assert dirs == {"jax_compilation_cache_dir": str(tmp_path)}
    assert seen["jax_persistent_cache_min_compile_time_secs"] == \
        cache.MIN_COMPILE_SECS["gpu"]


def test_init_states_live_outside_the_compile_cache(monkeypatch, tmp_path):
    """The init-state cache is driver state, not a compiled program: it goes
    to <checkout>/.gple_state whatever the compile cache's directory."""
    from gple_tpu.config import GPLEConfig
    from gple_tpu.driver import GPLEDriver

    assert cache.STATE_DIR == os.path.join(REPO, ".gple_state")
    state = tmp_path / "state"
    monkeypatch.setattr(cache, "STATE_DIR", str(state))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    monkeypatch.setattr(cache, "enable_persistent_cache", lambda: None)
    drv = GPLEDriver(GPLEConfig(num_points=16, init_cache=True))
    init = drv._init_cache_path()
    events = drv._event_hints_path()
    for path in (init, events):
        assert os.path.dirname(path) == str(state)
        assert not path.startswith(str(tmp_path / "xla"))
    assert init.endswith(".npz") and events.endswith(".json")
