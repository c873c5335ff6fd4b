"""The GPU entry scripts refuse to report a result without a GPU.

``chip_smoke.py`` and ``bench.py`` are the quickest proof that the system
runs on the card; here, on the CPU, they must exit non-zero and print no
result line."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=300):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=cwd, env=env)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    r = _run([str(script)], cwd=tmp_path)
    assert r.returncode != 0, r.stdout
    assert '"ok": true' not in r.stdout
    assert r.stdout.strip() == "", r.stdout


def test_bench_fails_without_gpu(tmp_path):
    r = _run([os.path.join(REPO, "bench.py"), "--quick"], cwd=tmp_path)
    assert r.returncode != 0, r.stdout
    assert r.stdout.strip() == "", r.stdout


def test_contract_line_has_exactly_the_two_keys():
    sys.path.insert(0, REPO)
    import chip_smoke

    line = chip_smoke.contract_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    d = json.loads(line)
    assert list(d) == ["ok", "device"]
    assert d["ok"] is True
    assert d["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                           "count": 1}


def test_smoke_input_file_parses_to_the_headline_config(tmp_path):
    """Phase c's reference-format input is the SAC N = 1024 headline run."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from gple_tpu.config import GPLEConfig

    path = tmp_path / "input"
    chip_smoke.write_input(str(path))
    cfg = GPLEConfig.from_input_file(str(path), model="SAC")
    assert (cfg.mass, cfg.x0, cfg.p0, cfg.sigma_p0) == (2000.0, -4.0, 20.0, 1.0)
    assert (cfg.output_time, cfg.reopt_time, cfg.dt) == (10.0, 10.0, 1.0)
    assert cfg.num_points == 1024
    # 21 ticks: frames at 0, 10, 20 and reopts at 10, 20
    assert cfg.output_freq == 10 and cfg.reopt_freq == 10
