"""The port's public surface against the JAX package's: every name a JAX
``__init__`` re-exports imports from the port's matching package path;
the host routines ``solve_problem`` and ``evaluate_host`` agree with the
JAX ones on lands; ``solve_instance`` is ``SDSolver.run`` with the JAX
package's printed lines."""

import ast
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import sqlp_tpu.sd.driver as jax_driver
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.models.routines import evaluate_host as jax_evaluate_host
from sqlp_tpu.models.routines import solve_problem as jax_solve_problem
from sqlp_tpu.models.smps_sto import sample_scenario as jax_sample_scenario
from sqlp_tpu_torch import SDConfig
from sqlp_tpu_torch.models import load_instance, sample_scenario
from sqlp_tpu_torch.models.routines import evaluate_host, solve_problem
from sqlp_tpu_torch.sd import SDSolver, solve_instance

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# never ported: JAX NamedShardings (the port's state_pspecs is the layout);
# PhaseTimers, whose synchronizing timers the port's spans
# (utils/profiling.py) replace
NOT_PORTED = {"state_shardings", "PhaseTimers"}


def _jax_exports():
    """{port package: names} from every JAX ``__init__`` that re-exports."""
    out = {}
    base = os.path.join(ROOT, "sqlp_tpu")
    for d, _, files in sorted(os.walk(base)):
        if "__init__.py" not in files:
            continue
        with open(os.path.join(d, "__init__.py")) as fh:
            tree = ast.parse(fh.read())
        names = [a.asname or a.name for node in tree.body
                 if isinstance(node, ast.ImportFrom) for a in node.names]
        if names:
            rel = os.path.relpath(d, ROOT).replace(os.sep, ".")
            out["sqlp_tpu_torch" + rel[len("sqlp_tpu"):]] = names
    return out


_EXPORTS = _jax_exports()


@pytest.mark.parametrize("package", sorted(_EXPORTS))
def test_port_reexports_jax_names(package):
    """Each name of the JAX ``__init__`` is an attribute of the port's
    package and listed in its ``__all__`` (``from ... import *``)."""
    mod = importlib.import_module(package)
    want = [n for n in _EXPORTS[package] if n not in NOT_PORTED]
    assert want
    missing = [n for n in want if getattr(mod, n, None) is None]
    assert not missing, missing
    assert set(want) <= set(mod.__all__)
    assert set(want) <= set(dir(mod))
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_public_names_import_no_jax_and_build_nothing():
    """Importing the package, then every public name of every package,
    then the CLI and the bench module, loads no JAX, no Triton, no kernel
    library and not the reference bench.py, and leaves CUDA
    uninitialized; the bare package imports not even torch."""
    code = (
        "import importlib, sys\n"
        "import sqlp_tpu_torch\n"
        "assert 'torch' not in sys.modules\n"
        f"for p in {sorted(_EXPORTS)!r}:\n"
        "    m = importlib.import_module(p)\n"
        "    [getattr(m, n) for n in m.__all__]\n"
        "import torch\n"
        "import sqlp_tpu_torch.bench, sqlp_tpu_torch.cli\n"
        "assert 'bench' not in sys.modules\n"
        "from sqlp_tpu_torch.ops.cuda import build\n"
        "assert build._lib is None and not torch.cuda.is_initialized()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton') or "
        "m.startswith(('jax.', 'jaxlib', 'triton.', 'sqlp_tpu.'))]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture(scope="module")
def lands_pair():
    return (jax_load_instance("lands"),
            load_instance("lands", dtype=torch.float64, device="cpu"))


def test_solve_problem_matches_jax(lands_pair):
    """The stage-2 LP at x = 5·1 under ten scenarios drawn by each
    package's ``sample_scenario`` from ``default_rng(3)``: the same draws;
    objective within 1e-9 relative, y and duals within 1e-8."""
    jinst, inst = lands_pair
    x = np.full(4, 5.0)
    jrng, rng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(10):
        jscen = jax_sample_scenario(jrng, jinst.sto)
        scen = sample_scenario(rng, inst.sto)
        assert [(p.row_name, p.col_name, v) for p, v in scen] == \
            [(p.row_name, p.col_name, v) for p, v in jscen]
        ref = jax_solve_problem(jinst.sp2, x, jscen)
        got = solve_problem(inst.sp2, torch.as_tensor(x), scen)
        assert got[0] == pytest.approx(ref[0], rel=1e-9)
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-8)
        assert np.any(got[2] != 0.0)


def test_evaluate_host_matches_jax(lands_pair):
    """The serial host MC estimate at x = 5·1 over 200 samples from
    ``default_rng(0)`` in both packages: within 1e-9 relative."""
    jinst, inst = lands_pair
    x = np.full(4, 5.0)
    ref = jax_evaluate_host(jinst.sp1, jinst.sp2, jinst.sto, x,
                            n_samples=200, rng=np.random.default_rng(0))
    got = evaluate_host(inst.sp1, inst.sp2, inst.sto, x, n_samples=200,
                        rng=np.random.default_rng(0))
    assert got == pytest.approx(ref, rel=1e-9)
    # the default generator is default_rng(0)
    assert evaluate_host(inst.sp1, inst.sp2, inst.sto, x,
                         n_samples=200) == got
    assert 350.0 < got < 450.0


def _assert_states_equal(a, b):
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x.numpy(), y.numpy(), equal_nan=True), name
        else:
            assert x == y, name


def test_solve_instance_is_sd_solver_run():
    """``solve_instance("lands", 40, device="cpu")`` at the default
    configuration is ``SDSolver(load_instance("lands"), cfg, seed=0)
    .run(40)`` bit for bit: the state and the logged history."""
    got = solve_instance("lands", 40, device="cpu", verbose=False,
                         log_every=10)
    ref = SDSolver(load_instance("lands", device="cpu"), SDConfig(), seed=0)
    ref.run(40, log_every=10)
    _assert_states_equal(got.state, ref.state)
    assert len(got.history) == 4
    assert got.history == ref.history
    assert got.lower_estimate == ref.lower_estimate


def test_solve_instance_prints_the_jax_lines(capsys, monkeypatch):
    """The printed lines are the JAX package's: its ``solve_instance``,
    with a stand-in solver that hands its callback this run's last stats
    in the JAX dtypes (the pool and cut counts are int32 there), prints
    the same iteration line; both end in the wall-time line."""
    solver = solve_instance("lands", 2, device="cpu", log_every=1)
    out = capsys.readouterr().out.splitlines()
    last = {k: (np.int32(v) if k in ("n_duals", "n_cuts_live")
                else np.float32(v)) for k, v in solver.history[-1].items()}

    class Replay:
        def __init__(self, inst, config, x0=None, seed=0):
            pass

        def run(self, n_iters, log_every=0, callback=None):
            callback(n_iters, last)

    monkeypatch.setattr(jax_driver, "SDSolver", Replay)
    jax_driver.solve_instance("lands", 2, log_every=1)
    ref = capsys.readouterr().out.splitlines()
    assert len(out) == len(ref) == 2
    assert out[0] == ref[0]
    assert re.fullmatch(r"\[lands\] iter 2: lb_est=\S+ inc_est=\S+ "
                        r"rho=\S+ duals=\d+ cuts=\d+", out[0]), out
    for line in (out[1], ref[1]):
        assert re.fullmatch(r"\[lands\] 2 iters in \d+\.\ds", line), line


def test_solve_instance_default_device_needs_the_card(capsys):
    """With no ``device`` argument on a host without CUDA it raises before
    any iteration and prints nothing: it never goes on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the default device is the card on a CUDA host")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_instance("lands", 1)
    assert capsys.readouterr().out == ""
