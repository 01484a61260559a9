"""Storm, the largest vendored instance (m2 x n2 528 x 1259, n1 121, m1
185, 117 random variables), through the port against the JAX package on
the CPU in float64: SD steps from x0 = 0, projected onto storm's
first-stage rows as both packages project it, on one numpy scenario
stream; then the MC evaluator's certified recourse values at the
resulting decision on one numpy panel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.algorithm import _scenario_rhs as jax_rhs
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs
from sqlp_tpu_torch.sd.driver import SDSolver

from test_torch_slice import _scenario_values

torch.set_num_threads(2)

# capacities above the step count: the reservoir never draws, so the run
# depends on the supplied scenarios alone
_CAP = dict(dtype="float64", max_scenarios=16, max_dual_vertices=16,
            max_cuts=8)
STEPS = 3
# rows of the recourse panel: certifying storm's recourse LPs in float64
# takes each package about 50 s at 64 rows on two CPU threads (the three
# steps about 55 s together), so the file runs near three minutes
PANEL = 64


@pytest.fixture(scope="module")
def storm_pair():
    """Both packages after STEPS storm iterations on one scenario stream,
    and the per-step estimates."""
    port = load_instance("storm", dtype=torch.float64, device="cpu")
    ref = jax_load_instance("storm", dtype=jnp.float64)
    ps = SDSolver(port, SDConfig(**_CAP), seed=0)
    js = JSDSolver(ref, JSDConfig(**_CAP), seed=0)
    traj = []
    for v in _scenario_values(port, STEPS, seed=21):
        a = ps.step_scenarios(values=v)
        b = js.step_scenarios(values=v)
        traj.append((float(a["cand_est"]), float(b["cand_est"]),
                     float(a["inc_est"]), float(b["inc_est"])))
    return ps, js, np.array(traj)


def test_storm_steps_match_jax(storm_pair):
    """The projected start and every step's candidate and incumbent
    estimates agree to 1e-6 relative (identical control flow in float64;
    only the order of reductions differs)."""
    ps, js, traj = storm_pair
    c, jc, i, ji = traj.T
    np.testing.assert_allclose(c, jc, rtol=1e-6)
    np.testing.assert_allclose(i, ji, rtol=1e-6)
    np.testing.assert_allclose(ps.x_incumbent, np.asarray(js.x_incumbent),
                               rtol=1e-6, atol=1e-6)


def test_storm_recourse_objs_match_jax(storm_pair):
    """_recourse_objs at the incumbent after the steps, on a numpy panel of
    PANEL rows: the same right-hand sides, and values within 1e-8 relative
    (both certify each value to the same validity bar in float64, or
    solve it exactly on the host)."""
    ps, js, _ = storm_pair
    x = np.array(js.x_incumbent, np.float64)
    vals = _scenario_values(ps.inst, PANEL, seed=22).reshape(PANEL, -1)
    d = vals - ps.inst.scenario_model.base.numpy()
    H = _scenario_rhs(ps.arrays, ps.inst.scenario_model, torch.as_tensor(d),
                      torch.as_tensor(x))
    jH = jax_rhs(js.arrays_local, js.inst.scenario_model, jnp.asarray(d),
                 jnp.asarray(x))
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-14)
    a = ps._recourse_objs(H)
    b = js._recourse_objs(jH)
    assert np.all(np.isfinite(a))
    np.testing.assert_allclose(a, b, rtol=1e-8)
