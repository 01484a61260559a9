"""The port's public entry points default to the CUDA card, and the CPU
crossover's batched LU returns whatever the intra-op thread count.

Without a card, an entry point called without ``device`` raises instead of
going on silently on the CPU; with one, it returns CUDA tensors. Whether a
card is present is decided inside each test.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from sqlp_tpu_torch.models.instance import (ARRAY_FIELDS, arrays_from_numpy,
                                            compile_instance,
                                            find_instance_dir,
                                            instance_from_numpy,
                                            load_instance)
from sqlp_tpu_torch.models.scenario import (SCENARIO_FIELDS,
                                            build_scenario_model,
                                            scenario_model_from_numpy)
from sqlp_tpu_torch.models.smps_cor import read_cor
from sqlp_tpu_torch.models.smps_sto import read_sto
from sqlp_tpu_torch.models.smps_tim import read_tim
from sqlp_tpu_torch.models.stage import get_smps_stage_template
from sqlp_tpu_torch.ops.pdhg import (PREPARED_FIELDS, prepare_lp,
                                     prepared_lp_from_numpy)
from sqlp_tpu_torch.sd.state import default_epigraph_spec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parsed(name="lands"):
    path = find_instance_dir(name)
    return (read_cor(os.path.join(path, f"{name}.cor")),
            read_tim(os.path.join(path, f"{name}.tim")),
            read_sto(os.path.join(path, f"{name}.sto")))


def _call(entry):
    """Call one entry point without ``device``; returns its tensors."""
    cpu = load_instance("lands", dtype=torch.float64, device="cpu")
    if entry == "load_instance":
        out = load_instance("lands")
        return [out.arrays.W, out.scenario_model.values]
    if entry == "compile_instance":
        out = compile_instance(*_parsed())
        return [out.arrays.W, out.scenario_model.values]
    if entry == "instance_from_numpy":
        out = instance_from_numpy(cpu)
        return [out.arrays.W, out.scenario_model.values]
    if entry == "arrays_from_numpy":
        out = arrays_from_numpy({f: getattr(cpu.arrays, f).numpy()
                                 for f in ARRAY_FIELDS})
        return [out.W, out.senses2]
    if entry == "scenario_model_from_numpy":
        sm = cpu.scenario_model
        out = scenario_model_from_numpy(
            {f: getattr(sm, f).numpy() for f in SCENARIO_FIELDS})
        return [out.values, out.rv_row]
    if entry == "build_scenario_model":
        cor, tim, sto = _parsed()
        out = build_scenario_model(sto, get_smps_stage_template(cor, tim, 2))
        return [out.values, out.rv_row]
    if entry == "prepared_lp_from_numpy":
        a = cpu.arrays
        lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
        out = prepared_lp_from_numpy({f: getattr(lp, f).numpy()
                                      for f in PREPARED_FIELDS})
        return [out.K, out.is_eq]
    if entry == "default_epigraph_spec":
        out = default_epigraph_spec()
        return [out.obj_weight, out.lower_bound]
    raise AssertionError(entry)


@pytest.mark.parametrize("entry", [
    "load_instance", "compile_instance", "instance_from_numpy",
    "arrays_from_numpy", "scenario_model_from_numpy",
    "build_scenario_model", "prepared_lp_from_numpy",
    "default_epigraph_spec"])
def test_entry_point_defaults_to_the_card(entry):
    """Without ``device`` the entry point places its tensors on the CUDA
    card; on a host without one it raises a RuntimeError rather than
    returning CPU tensors."""
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _call(entry))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _call(entry)


_SOLVE = textwrap.dedent("""
    import torch
    from sqlp_tpu_torch.ops.crossover import _batched_solve

    torch.set_num_threads(4)
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.float64):
        A = torch.randn((16, 175, 175), generator=g, dtype=dt)
        M = A @ A.transpose(1, 2) + torch.eye(175, dtype=dt)
        rhs = torch.randn((16, 175), generator=g, dtype=dt)
        x4 = _batched_solve(M, rhs)
        assert torch.get_num_threads() == 4
        torch.set_num_threads(1)
        x1 = _batched_solve(M, rhs)
        torch.set_num_threads(4)
        assert torch.equal(x4, x1), dt
        assert bool(torch.isfinite(x4).all()), dt
    print("returned")
""")


def test_batched_solve_returns_under_four_threads():
    """The crossover's batched LU on an ssn-shaped [16, 175, 175] system
    returns under 4 intra-op threads (MKL's batched getrf hangs there
    unless the call runs on one), bitwise equal to the one-thread result,
    and leaves the caller's thread count as it was. Run in its own
    process with its own 120 s limit: a hang fails the test instead of
    the run."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _SOLVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "returned" in proc.stdout


_INV = textwrap.dedent("""
    import torch
    from sqlp_tpu_torch.ops.prox_qp import _inv

    torch.set_num_threads(4)
    g = torch.Generator().manual_seed(0)
    # the active-set polish's Schur system of the certification
    # polish's projection QP on ssn (mA = 253 rows), one per QP of an
    # R = 8 batch
    A = torch.randn((8, 253, 300), generator=g, dtype=torch.float64)
    M = A @ A.transpose(1, 2) + torch.eye(253, dtype=torch.float64)
    Mi4 = _inv(M)
    assert torch.get_num_threads() == 4
    torch.set_num_threads(1)
    Mi1 = _inv(M)
    torch.set_num_threads(4)
    assert torch.equal(Mi4, Mi1)
    assert bool(torch.isfinite(Mi4).all())
    eye = torch.eye(253, dtype=torch.float64).expand(8, 253, 253)
    assert float((M @ Mi4 - eye).abs().max()) < 1e-8
    print("returned")
""")


def test_inverse_returns_under_four_threads():
    """The master QP's batched f64 inverse (``ops/prox_qp.py:_inv``) on
    eight ssn-shaped [253, 253] systems returns under 4 intra-op threads
    (MKL's batched LU hangs there unless the call runs on one), bitwise
    equal to the one-thread result, and leaves the caller's thread count
    as it was. Run in its own process with its own 120 s limit: a hang
    fails the test instead of the run."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _INV], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "returned" in proc.stdout
