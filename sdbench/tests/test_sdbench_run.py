"""The command's refusals, and a short run of every cell on the card.

The card test is marked ``cuda`` and decides inside its fixture whether
a card is present; on a host without one it skips.
"""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from sdbench import harness
from sdbench.run import forbidden_modules

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cmd(cwd, cell="ssn.mc_ub", seconds="1", trace="0", env=None):
    return subprocess.run(
        [sys.executable, "sdbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 77), "--seconds", seconds, "--trace", trace],
        cwd=cwd, capture_output=True, text=True, timeout=1500, env=env)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("jax.numpy", "sqlp_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "sqlp_tpu_torch_x",
                        types.ModuleType("sqlp_tpu_torch_x"))
    bad = forbidden_modules()
    assert "jax.numpy" in bad and "sqlp_tpu.ops" in bad and "flax" in bad
    assert not any(m.startswith("sqlp_tpu_torch") for m in bad)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _cmd(ROOT, env=env)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "sdbench"), tmp_path / "sdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = _cmd(str(tmp_path), env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_on_the_card(card, cell, trace):
    # the EF's check reads the progress of a whole window's rounds
    seconds = str(BENCH["run_seconds"]) if cell.endswith("ef_cert") else "2"
    out = _cmd(ROOT, cell=cell, seconds=seconds, trace=trace)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == card
    assert list(res)[-1] == "checks"
    c = harness.load_cell(cell)
    want = c.per_layer if trace == "1" else c.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for name, m in res["metrics"].items():
            if "roofline_share" in name:
                assert 0 < m["value"] <= 100
