"""The port's SD slice end to end against the JAX package: whole SD steps
on the same numpy scenario stream, the MC evaluator's certified recourse
values on one panel, the checkpoint schema, and the CLI."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu.utils.checkpoint import save_state
from sqlp_tpu_torch.config import PDHGConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.driver import SDSolver
from sqlp_tpu_torch.sd.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANDS_OPT = 381.8533333

# capacities above the iteration count: the reservoir never draws, so the
# run depends on the supplied scenarios alone
_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)
_X0 = {"lands": np.full(4, 3.0), "transship": None}


def _scenario_values(inst, n, seed):
    """[n, 1, 1, R] raw scenario values drawn by numpy from the marginals."""
    m = inst.scenario_model
    rng = np.random.default_rng(seed)
    out = np.empty((n, m.n_rv))
    for k in range(m.n_rv):
        d = int(m.dist_type[k])
        if d == 0:
            out[:, k] = rng.choice(m.values[k].numpy(), size=n)
        elif d == 1:
            out[:, k] = float(m.mean[k]) + float(m.std[k]) * \
                rng.standard_normal(n)
        else:
            out[:, k] = float(m.left[k]) + float(m.width[k]) * rng.random(n)
    return out.reshape(n, 1, 1, m.n_rv)


def _pair(name, **kw):
    port = load_instance(name, dtype=torch.float64)
    ref = jax_load_instance(name, dtype=jnp.float64)
    x0 = _X0[name]
    ps = SDSolver(port, SDConfig(**_CAP, **kw), x0=x0, seed=0)
    js = JSDSolver(ref, JSDConfig(**_CAP, **kw), x0=x0, seed=0)
    return port, ps, js


@pytest.fixture(scope="module")
def lands_pair():
    """Both packages after 30 lands iterations on one scenario stream."""
    port, ps, js = _pair("lands")
    vals = _scenario_values(port, 30, seed=11)
    traj = []
    for v in vals:
        a = ps.step_scenarios(values=v)
        b = js.step_scenarios(values=v)
        traj.append((float(a["cand_est"]), float(b["cand_est"]),
                     float(a["inc_est"]), float(b["inc_est"])))
    return ps, js, np.array(traj)


def _check_trajectory(traj, early):
    """Tight over the early window (1e-6 relative: identical control flow
    in float64, only reduction order differs); the tail only within 5%,
    because a ~1e-13 difference can eventually flip a near-tied discrete
    branch (argmax or prune), after which both runs are distinct valid SD
    runs (the reason given at tests/test_parity_trajectory.py:82-90)."""
    c, jc, i, ji = traj.T
    np.testing.assert_allclose(c[:early], jc[:early], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(i[:early], ji[:early], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c[early:], jc[early:], rtol=0.05)
    np.testing.assert_allclose(i[early:], ji[early:], rtol=0.05)


def test_lands_steps_match_jax(lands_pair):
    ps, js, traj = lands_pair
    _check_trajectory(traj, early=25)
    # the incumbent sits near the optimizer in both runs
    assert np.linalg.norm(ps.x_incumbent - js.x_incumbent) < 1.0


def test_transship_steps_match_jax():
    port, ps, js = _pair("transship")
    vals = _scenario_values(port, 10, seed=12)
    traj = []
    for v in vals:
        a = ps.step_scenarios(values=v)
        b = js.step_scenarios(values=v)
        traj.append((float(a["cand_est"]), float(b["cand_est"]),
                     float(a["inc_est"]), float(b["inc_est"])))
    _check_trajectory(np.array(traj), early=10)
    np.testing.assert_allclose(ps.x_incumbent, js.x_incumbent, rtol=1e-5,
                               atol=1e-5)


def test_state_from_numpy_round_trip(lands_pair, tmp_path):
    """A state written by sqlp_tpu.utils.checkpoint.save_state loads into
    the port field for field (bitwise), and state_to_numpy writes the same
    fields back (the PRNG key has no counterpart and is skipped)."""
    ps, js, _ = lands_pair
    path = str(tmp_path / "state.npz")
    save_state(path, js.state, instance="lands")
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    st = state_from_numpy(fields, template=ps.state)
    back = state_to_numpy(st)
    assert set(back) == set(fields) - {"key", "__meta_instance"}
    for k, v in back.items():
        np.testing.assert_array_equal(v, fields[k], err_msg=k)
        assert v.dtype == fields[k].dtype, k


@pytest.mark.parametrize("budget", ["default", "starved"])
def test_recourse_objs_match_jax(lands_pair, budget, tmp_path):
    """_recourse_objs on one fixed H panel from the same state (the JAX
    state loaded into the port). 'starved' caps PDHG at one round against
    a 1e-9 validity bar, so elements walk the whole escalation ladder
    (pool-warm-started retry, f64 re-solve, exact host solve) in both
    packages. Values agree to 1e-6 relative: both take the same path on
    the same float64 data and certify each value or solve it exactly."""
    ps, js, _ = lands_pair
    path = str(tmp_path / "s.npz")
    save_state(path, js.state)
    with np.load(path) as z:
        ps.state = state_from_numpy({k: z[k] for k in z.files}, ps.state)
    if budget == "starved":
        import dataclasses
        starve = dict(max_iters=80, valid_tol=1e-9)
        ps.config = ps.config.replace(pdhg=PDHGConfig(**starve))
        js.config = dataclasses.replace(js.config,
                                        pdhg=JPDHGConfig(**starve))
    x = np.array([2.0, 4.0, 3.0, 3.0])
    vals = _scenario_values(ps.inst, 64, seed=13).reshape(64, -1)
    d = vals - ps.inst.scenario_model.base.numpy()
    from sqlp_tpu.sd.algorithm import _scenario_rhs as jax_rhs
    from sqlp_tpu_torch.sd.algorithm import _scenario_rhs
    H = _scenario_rhs(ps.arrays, ps.inst.scenario_model, torch.as_tensor(d),
                      torch.as_tensor(x))
    jH = jax_rhs(js.arrays_local, js.inst.scenario_model, jnp.asarray(d),
                 jnp.asarray(x))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-14)
    a = ps._recourse_objs(H)
    b = js._recourse_objs(jH)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert ps.host_fallback_count == getattr(js, "host_fallback_count", 0)
    if budget == "starved":
        assert ps.host_fallback_count > 0


def test_cli_solve_lands():
    """python -m sqlp_tpu_torch solve lands --iters 50 on the CPU exits 0
    and prints finite bounds near the lands optimum (the 6-unit band of
    tests/test_sd_e2e.py:43-46, doubled for a 50-iteration f32 run)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "sqlp_tpu_torch", "solve", "lands", "--iters",
         "50", "--device", "cpu", "--eval-samples", "256"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", proc.stdout)
    assert m, proc.stdout
    lb, ub = float(m.group(1)), float(m.group(2))
    assert abs(lb - LANDS_OPT) < 12.0 and abs(ub - LANDS_OPT) < 12.0, (lb, ub)


@pytest.mark.parametrize("flags", [
    ["--x0", "crash"], ["--replications", "4"], ["--certify"],
    ["--mesh", "8"], ["--proposal-sto", "other.sto"], ["--cut-refresh", "64"],
    ["--sampling", "stratified"]])
def test_cli_refuses_unported_flags(flags, capsys):
    """Flags whose features are not ported exit 2 before any work, with a
    message naming the ROADMAP item."""
    from sqlp_tpu_torch.cli import main
    assert main(["solve", "lands", "--device", "cpu", *flags]) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_port_never_imports_jax():
    """Importing the whole port (driver, CLI, kernels' wrappers) loads no
    JAX module: the package runs where JAX is not installed."""
    code = ("import sys, sqlp_tpu_torch.cli, sqlp_tpu_torch.sd.driver, "
            "sqlp_tpu_torch.ops.cuda.build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'sqlp_tpu.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
