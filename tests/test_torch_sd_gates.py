"""Gates for SD paths the port already carries: random cost (newsprice),
bound folding (saleslim) and transfer randomness (farmer) step for step
against the JAX package on one numpy scenario stream, beside
tests/test_{random_cost,bound_folding,transfer_randomness}.py; and the
oracle trajectory: lands with host HiGHS duals in place of the PDHG
solve, held against the reference's golden (tests/test_parity_trajectory.py)
on the golden's own seed-42 stream, drawn with the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu_torch.sd.algorithm as alg
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.models.scenario import sample_deltas as jax_sample_deltas
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu_torch.config import QPConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.routines import oracle_solve_batch
from sqlp_tpu_torch.sd.driver import SDSolver
from sqlp_tpu_torch.sd.state import state_from_numpy

from test_parity_trajectory import GOLDEN_CAND_EST, GOLDEN_X_INC
from test_torch_slice import _check_trajectory, _scenario_values

torch.set_num_threads(1)

_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)


def _pair(name, x0):
    port = load_instance(name, dtype=torch.float64, device="cpu")
    ref = jax_load_instance(name, dtype=jnp.float64)
    x0 = None if x0 is None else np.asarray(x0)
    ps = SDSolver(port, SDConfig(**_CAP), x0=x0, seed=0)
    js = JSDSolver(ref, JSDConfig(**_CAP), x0=x0, seed=0)
    assert ps.obj_scale == js.obj_scale
    return port, ps, js


@pytest.mark.parametrize("name,iters,x0", [
    ("newsprice", 15, None),        # random cost: per-scenario q_s
    ("farmer", 12, (2.0, 2.0)),     # transfer randomness: T_s x
])
def test_steps_match_jax(name, iters, x0):
    """The same numpy scenario stream through both packages' SD steps:
    the candidate and incumbent estimates within the tolerance of
    ``test_torch_slice._check_trajectory`` (1e-6 relative while the
    control flow is identical; a near-tied discrete branch may later
    part the two valid runs, so the tail is held to 5 %), and the
    incumbents close."""
    port, ps, js = _pair(name, x0)
    vals = _scenario_values(port, iters, seed=21)
    traj = []
    for v in vals:
        a = ps.step_scenarios(values=v)
        b = js.step_scenarios(values=v)
        traj.append((float(a["cand_est"]), float(b["cand_est"]),
                     float(a["inc_est"]), float(b["inc_est"])))
    traj = np.array(traj)
    assert np.all(np.isfinite(traj))
    _check_trajectory(traj, early=iters - 2)
    np.testing.assert_allclose(ps.x_incumbent, js.x_incumbent, rtol=1e-4,
                               atol=1e-4 * (1 + np.abs(js.x_incumbent).max()))


def test_bound_folding_steps_match_jax():
    """saleslim (bound folding), 15 teacher-forced steps: each port step
    starts from the JAX package's state and takes the same scenario. The
    free-running trajectories part at iteration 0, in the first master
    QP: the port returns x = 0 and the reference x = 10, both polished at
    a KKT error of 1e-16, which does not check the multipliers' signs
    (the master polish's finding of ROADMAP C). So the step's work before
    the master is compared (the estimates, the prox weight, the cuts and
    the incumbent, to 1e-7 relative; counters exactly), not the master's
    point."""
    port, ps, js = _pair("saleslim", None)
    fields = [f.name for f in dataclasses.fields(ps.state)]
    for i, v in enumerate(_scenario_values(port, 15, seed=21)):
        ps.state = state_from_numpy(
            {f: np.asarray(getattr(js.state, f)) for f in fields}, ps.state)
        a = ps.step_scenarios(values=v)
        b = js.step_scenarios(values=v)
        for k in ("cand_est", "inc_est", "rho"):
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-7,
                                                abs=1e-9), (i, k)
        for k in ("is_improved", "n_cuts_live", "n_duals"):
            assert int(a[k]) == int(b[k]), (i, k)
        for f in ("cut_alpha", "cut_beta", "inc_alpha", "inc_beta",
                  "x_incumbent", "total_weight"):
            want = np.asarray(getattr(js.state, f))
            np.testing.assert_allclose(
                getattr(ps.state, f).numpy(), want, rtol=1e-7,
                atol=1e-7 * (1.0 + np.abs(want).max()), err_msg=f"{i} {f}")


def test_oracle_trajectory_matches_golden(monkeypatch):
    """lands, x0 = (3, 3, 3, 3), constant rho 0.1, no crossover, exact
    host duals (``oracle_solve_batch``) on the golden's seed-42 stream:
    the JAX package draws it (``sd_step`` splits the state key, then
    ``sample_deltas``) and the port steps on it. Held to the golden as
    the reference's own test holds it (tests/test_parity_trajectory.py:
    1e-6 over the first 20 iterations, 5 % after, where a near-tied
    branch may flip across machines)."""
    jcfg = JSDConfig(dtype="float64", dual_crossover=False,
                     max_scenarios=48, max_dual_vertices=48, max_cuts=12,
                     quad_schedule="constant", quad_scalar_init=0.1)
    ref = jax_load_instance("lands", dtype=jnp.float64)
    js = JSDSolver(ref, jcfg, x0=np.full(4, 3.0), seed=42)
    key = js.state.key
    stream = []
    for _ in range(30):
        key, k_sample = jax.random.split(key)
        stream.append(np.asarray(jax_sample_deltas(
            k_sample, js.scenario_model, 1, method="iid"), np.float64))
    cfg = SDConfig(dtype="float64", dual_crossover=False, max_scenarios=48,
                   max_dual_vertices=48, max_cuts=12,
                   quad_schedule="constant", quad_scalar_init=0.1,
                   qp=QPConfig(tol=1e-10, max_iters=8_000))
    monkeypatch.setattr(alg, "solve_batch", oracle_solve_batch)
    port = load_instance("lands", dtype=torch.float64, device="cpu")
    ps = SDSolver(port, cfg, x0=np.full(4, 3.0), seed=42)
    cand = np.array([float(ps.step_scenarios(deltas=d.reshape(1, 1, -1))
                           ["cand_est"]) for d in stream])
    np.testing.assert_allclose(cand[:20], GOLDEN_CAND_EST[:20], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(cand[20:], GOLDEN_CAND_EST[20:], rtol=0.05)
    assert np.linalg.norm(ps.x_incumbent - GOLDEN_X_INC) < 2.5


def test_oracle_solve_batch_is_exact():
    """The oracle returns the host LP's optimum per row, in the port's
    dual convention, on the panel's device and dtype."""
    from sqlp_tpu_torch.models.routines import solve_lp_host
    from sqlp_tpu_torch.ops.pdhg import prepare_lp

    inst = load_instance("transship", dtype=torch.float64, device="cpu")
    a = inst.arrays
    prep = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    H = a.r[None, :].repeat(3, 1) + torch.linspace(0.0, 1.0, 3)[:, None]
    obj, Y, Pi, stats = oracle_solve_batch(prep, H)
    assert obj.dtype == torch.float64 and bool(stats["pdhg_valid"].all())
    for b in range(3):
        o, y, pi = solve_lp_host(a.q.numpy(), a.W.numpy(), H[b].numpy(),
                                 a.senses2.numpy(), a.lb2.numpy(),
                                 a.ub2.numpy())
        assert float(obj[b]) == pytest.approx(o, rel=1e-9, abs=1e-9)
        np.testing.assert_allclose(Pi[b].numpy(), pi, atol=1e-7)
