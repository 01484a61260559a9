"""The port's replications + compromise path against the JAX package on the
same numpy inputs: the replicated SD step, the compromise decision, the
periodic cut refresh, the variance-reduced sampling maps and the
batch-mean confidence interval of the MC evaluator."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.models.scenario as jax_scenario
import sqlp_tpu.sd.driver as jax_driver
import sqlp_tpu_torch.models.scenario as scenario
import sqlp_tpu_torch.sd.driver as driver
from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.config import QPConfig as JQPConfig
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.algorithm import _refresh_cuts as jax_refresh_cuts
from sqlp_tpu.sd.algorithm import sd_step as jax_sd_step
from sqlp_tpu.sd.compromise import _merge_states as jax_merge_states
from sqlp_tpu.sd.compromise import compromise_decision as jax_compromise
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu.sd.master import assemble_master as jax_assemble_master
from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.ops.prox_qp import solve_qp
from sqlp_tpu_torch.sd import algorithm
from sqlp_tpu_torch.sd.algorithm import (_refresh_cuts, sd_step,
                                         sd_step_replicated)
from sqlp_tpu_torch.sd import compromise
from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver
from sqlp_tpu_torch.sd.state import (stack_states, state_at,
                                     state_from_numpy, state_to_numpy)

from test_torch_slice import _scenario_values

torch.set_num_threads(1)

R = 3
# capacities above the iteration count (the reservoir never draws), f64,
# subproblems to 1e-9, and no cold warm retry of the master on either
# side: the replicated step drops it, as the reference's vmap does
_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)
_X0 = {"lands": np.full(4, 3.0), "transship": None}


def _configs():
    port = SDConfig(**_CAP, pdhg=PDHGConfig(tol=1e-9, max_iters=40_000),
                    qp=dataclasses.replace(SDConfig().qp, warm_retry=False))
    ref = JSDConfig(**_CAP, pdhg=JPDHGConfig(tol=1e-9, max_iters=40_000),
                    qp=dataclasses.replace(JSDConfig().qp,
                                           warm_retry=False))
    return port, ref


def _jax_states_to_port(jstates, template):
    """JAX SDStates -> port states (numpy in between; PRNG keys dropped)."""
    fields = [f.name for f in dataclasses.fields(template)]
    return [state_from_numpy({f: np.asarray(getattr(js, f)) for f in fields},
                             template) for js in jstates]


def _run_pair(name, iters, seed):
    """R JAX solvers step sequentially, each on its own numpy scenarios;
    before every step their states, stacked into the port, take one port
    sd_step_replicated on the same scenarios (each step starts from the
    reference's state, so a difference cannot compound). Returns (port
    solver, JAX solvers, records): per step the port's new stacked state
    and stats, the JAX new states and stats, and the batched master QP the
    port solved (operands, keywords)."""
    cfg, jcfg = _configs()
    port = load_instance(name, dtype=torch.float64, device="cpu")
    ref = jax_load_instance(name, dtype=jnp.float64)
    ps = SDReplications(port, cfg, n_replications=R, x0=_X0[name], seed=0)
    js = [JSDSolver(ref, jcfg, x0=_X0[name], seed=r) for r in range(R)]
    vals = _scenario_values(port, iters * R, seed=seed).reshape(
        iters, R, 1, port.n_rv)
    base = port.scenario_model.base.numpy()
    template = state_at(ps.state, 0)
    masters = []

    def capture(*a, **k):
        masters.append((a, k))
        return solve_qp(*a, **k)

    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(algorithm, "solve_qp", capture)
        for i in range(iters):
            ps.state = stack_states(_jax_states_to_port(
                [j.state for j in js], template))
            d = torch.as_tensor(vals[i] - base)
            new, st = sd_step_replicated(
                ps.arrays, ps.scenario_model, ps.espec, ps.prep_sub,
                ps.state, ps.config, ps.generators, deltas=d)
            jstats = []
            for r, j in enumerate(js):
                j.state, b = jax_sd_step(
                    j.arrays, j.scenario_model, j.espec, j.prep_sub,
                    j.state, j.config, deltas=jnp.asarray(
                        d[r].reshape(1, 1, -1).numpy()))
                jstats.append(b)
            records.append((new, st, [j.state for j in js], jstats,
                            masters.pop()))
            ps.state = new
    return ps, js, records


@pytest.fixture(scope="module")
def lands_reps():
    return _run_pair("lands", 20, seed=21)


# state fields the step sets before its master solve (the master's
# solution, the candidate it yields and the cut duals follow from the QP)
_PRE_MASTER = ("cut_alpha", "cut_beta", "cut_mark", "cut_x", "inc_alpha",
               "inc_beta", "total_weight", "x_incumbent", "duals",
               "scen_deltas", "scen_weights", "sub_warm_Y", "sub_warm_L",
               "quad_scalar")
_EXACT = ("cut_live", "inc_valid", "n_duals", "n_scen", "it", "xover_dry")
# what the recourse duals decide: compared only where they are unique
_DUAL_DERIVED = ("duals", "sub_warm_L", "cut_alpha", "cut_beta",
                 "inc_alpha", "inc_beta", "n_duals")


def _check_replicated_steps(records, arrays, espec, duals_unique):
    """Each step, each replication, against the JAX sd_step from the same
    state:

    * the stats before the master (cand/inc estimates, rho) and the state
      fields the step sets before the master to 1e-7 relative: the LP
      solves are to 1e-9 in float64, and the one flattened panel restarts
      each element as its own panel does, up to the reduction order of
      the batched products;
    * counters and masks exactly;
    * where the recourse duals are unique, the assembled master QP against
      the reference's ``assemble_master`` on its new state, to 1e-7;
    * the batched master's solution bit for bit against the port's own
      unbatched ``solve_qp`` of that replication's QP (the QP solver's
      parity with the reference is tests/test_torch_prox_qp.py).

    Lands' recourse LPs are dual-degenerate: a 1e-9 solve stops at a point
    of the optimal dual face that moves with rounding (up to 1e-4 relative
    here, the same between the port's unbatched sd_step and the
    reference), so the duals and the cuts built from them are compared
    where they are unique, on transship. The master's solution is not
    compared with the reference's: when the incumbent cut coincides with
    a new cut (always at iteration 0) the polish's Schur system is
    singular up to its 1e-8 regularization, so the polished point is set
    by the rounding of the explicit inverse (ROADMAP C)."""
    skip = () if duals_unique else _DUAL_DERIVED
    for i, (new, st, jstates, jstats, (ops, kw)) in enumerate(records):
        for r in range(R):
            where = f"step {i} replication {r}: "
            got = state_to_numpy(state_at(new, r))
            want = {f: np.asarray(getattr(jstates[r], f)) for f in got}
            for f in _PRE_MASTER:
                if f in skip:
                    continue
                scale = 1.0 + np.abs(want[f]).max(initial=0.0)
                np.testing.assert_allclose(got[f], want[f], rtol=1e-7,
                                           atol=1e-7 * scale,
                                           err_msg=where + f)
            for f in _EXACT:
                if f not in skip:
                    np.testing.assert_array_equal(got[f], want[f],
                                                  err_msg=where + f)
            for k in ("cand_est", "inc_est", "rho"):
                assert float(st[k][r]) == pytest.approx(
                    float(jstats[r][k]), rel=1e-7, abs=1e-9), where + k
            for k in ("is_improved", "n_cuts_live"):
                assert int(st[k][r]) == int(jstats[r][k]), where + k
            mine = [t[r] for t in ops[:6]]
            if duals_unique:
                want_ops = jax_assemble_master(
                    arrays, espec, jstates[r],
                    jnp.asarray(float(jstats[r]["rho"]), jnp.float64))
                for a, b in zip(mine, want_ops):
                    b = np.asarray(b)
                    fin = np.isfinite(b)
                    np.testing.assert_array_equal(np.isfinite(a.numpy()),
                                                  fin)
                    scale = 1.0 + np.abs(b[fin]).max(initial=0.0)
                    np.testing.assert_allclose(
                        a.numpy()[fin], b[fin], rtol=1e-7,
                        atol=1e-7 * scale, err_msg=where + "master")
            z, mu, _ = solve_qp(*mine, ops[6], z0=kw["z0"][r],
                                mu0=kw["mu0"][r],
                                rho_init=kw["rho_init"][r])
            assert torch.equal(z, new.master_z[r])
            assert torch.equal(mu, new.master_mu[r])


def test_replicated_step_matches_jax_lands(lands_reps):
    """R = 3 lockstep replications on lands, 20 teacher-forced iterations
    (see _check_replicated_steps for what is compared and why)."""
    _, js, records = lands_reps
    _check_replicated_steps(records, js[0].arrays, js[0].espec,
                            duals_unique=False)


def test_replicated_step_matches_jax_transship():
    """As above on transship (normal marginals, 35 x 77 recourse), 10
    iterations, with the duals, the cuts and the assembled masters."""
    _, js, records = _run_pair("transship", 10, seed=22)
    _check_replicated_steps(records, js[0].arrays, js[0].espec,
                            duals_unique=True)


def test_replicated_step_with_one_replication_is_sd_step():
    """R = 1: the replicated step is sd_step without the master's cold
    retry, bit for bit (one PDHG panel, the batched QP's CPU products are
    the unbatched ones)."""
    cfg, _ = _configs()
    port = load_instance("lands", dtype=torch.float64, device="cpu")
    one = SDSolver(port, cfg, x0=_X0["lands"], seed=0)
    reps = SDReplications(port, cfg, n_replications=1, x0=_X0["lands"],
                          seed=0)
    vals = _scenario_values(port, 8, seed=23)
    base = port.scenario_model.base.numpy()
    for v in vals:
        d = torch.as_tensor(v - base)
        one.state, a = sd_step(one.arrays, one.scenario_model, one.espec,
                               one.prep_sub, one.state, one.config,
                               one.generator, deltas=d)
        reps.state, b = sd_step_replicated(
            reps.arrays, reps.scenario_model, reps.espec, reps.prep_sub,
            reps.state, reps.config, reps.generators, deltas=d[None, 0])
        assert float(a["cand_est"]) == float(b["cand_est"][0])
    got = state_to_numpy(state_at(reps.state, 0))
    for k, v in state_to_numpy(one.state).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_stacked_state_numpy_round_trip(lands_reps):
    """A stacked [R, ...] state goes through state_to_numpy /
    state_from_numpy (stacked template) unchanged, and stack_states of the
    JAX solvers' states equals their jnp stack."""
    ps, js, _ = lands_reps
    back = state_from_numpy(state_to_numpy(ps.state), template=ps.state)
    for k, v in state_to_numpy(back).items():
        np.testing.assert_array_equal(v, state_to_numpy(ps.state)[k])
    stacked = stack_states(_jax_states_to_port([j.state for j in js],
                                               state_at(ps.state, 0)))
    for k, v in state_to_numpy(stacked).items():
        np.testing.assert_array_equal(
            v, np.stack([np.asarray(getattr(j.state, k)) for j in js]))


def _master_objective(ops, x, n1):
    """The master QP's objective at first-stage point x with every eta at
    the least value its cut rows allow: 1/2 p x^2 + g@(x, eta)."""
    p, g, A, l = (np.asarray(t, np.float64) for t in ops[:4])
    obj = 0.5 * p[:n1] @ (x * x) + g[:n1] @ x
    for e in range(n1, A.shape[1]):
        rows = (A[:, e] == 1.0) & np.isfinite(l)
        obj += g[e] * np.max(l[rows] - A[rows, :n1] @ x)
    return obj


def test_compromise_decision_matches_jax(lands_reps, monkeypatch):
    """compromise_decision on the same three JAX states in both packages:

    * x_bar to 1e-14 (a mean of the same incumbents, summed in another
      order);
    * the merged compromise QP (cut pools concatenated with weights 1/R,
      prox toward x_bar, objective scaled) to 1e-12 relative against the
      reference's _merge_states + assemble_master;
    * x_compromise box- and row-feasible, with a compromise objective
      within 1e-5 relative of the reference's point's. The points
      themselves are not compared: merged pools repeat cuts, the polish's
      Schur system is then singular up to its 1e-8 regularization, and
      the polished point moves along a flat direction of the objective
      with the rounding of the explicit inverse (the reference itself
      lands 0.5% apart on lands under jit and op by op; ROADMAP C)."""
    ps, js, _ = lands_reps
    qp = dict(tol=1e-9, max_iters=8_000)
    states = _jax_states_to_port([j.state for j in js],
                                 state_at(ps.state, 0))
    seen = []

    def capture(*a, **k):
        seen.append(a[:6])
        return solve_qp(*a, **k)

    monkeypatch.setattr(compromise, "solve_qp", capture)
    x, info = compromise.compromise_decision(
        ps.inst, states, ps.especs, rho=1.0, qp_config=QPConfig(**qp),
        obj_scale=ps.obj_scale)
    jx, jinfo = jax_compromise(js[0].inst, [j.state for j in js],
                               [j.espec for j in js], rho=1.0,
                               qp_config=JQPConfig(**qp),
                               obj_scale=js[0].obj_scale)
    np.testing.assert_allclose(info["x_bar"], jinfo["x_bar"], rtol=1e-14)

    s = js[0].obj_scale
    base = js[0].inst.arrays
    arrays = dataclasses.replace(base, c=base.c / s, q=base.q / s)
    merged, espec = jax_merge_states([j.state for j in js],
                                     [j.espec for j in js], 1.0 / R)
    merged = dataclasses.replace(merged,
                                 x_incumbent=jnp.asarray(jinfo["x_bar"]))
    want = jax_assemble_master(arrays, espec, merged,
                               jnp.asarray(1.0 / s, jnp.float64))
    for a, b in zip(seen[0], want):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(fin, np.isfinite(a.numpy()))
        scale = 1.0 + np.abs(b[fin]).max(initial=0.0)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], rtol=1e-12,
                                   atol=1e-12 * scale)

    lo, hi = (np.asarray(t) for t in (js[0].arrays.lb1, js[0].arrays.ub1))
    assert np.all(x >= lo) and np.all(x <= hi)
    assert info["projection_distance"] == 0.0
    n1 = x.shape[0]
    f, jf = (_master_objective(want, v, n1) for v in (x, jx))
    assert f == pytest.approx(jf, rel=1e-5)
    assert bool(info["qp_converged"]) and bool(jinfo["qp_converged"])


def test_refresh_cuts_matches_jax(lands_reps):
    """_refresh_cuts on one JAX state after 20 iterations: every live cut
    rebuilt at its stored x against the current pool (alpha, beta to
    1e-12 relative: the same float64 argmax and sums), marks reset to the
    epigraph weight, dead slots untouched."""
    ps, js, _ = lands_reps
    j = js[1]
    st = _jax_states_to_port([j.state], state_at(ps.state, 0))[0]
    assert bool(st.cut_live.any())
    got = _refresh_cuts(ps.arrays, ps.scenario_model, st)
    ref = jax_refresh_cuts(j.arrays, j.scenario_model, j.state)
    for f in ("cut_alpha", "cut_beta", "cut_mark"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), r, rtol=1e-12,
                                   atol=1e-12 * (1 + np.abs(r).max()))


def _patched_panels(monkeypatch, module, panels, to_array):
    """Make module._uniform_panel return the given panels in turn."""
    it = iter(panels)
    monkeypatch.setattr(module, "_uniform_panel",
                        lambda *a, **k: to_array(next(it)))


@pytest.mark.parametrize("complement", [False, True])
@pytest.mark.parametrize("method", ["antithetic", "stratified"])
def test_variance_reduced_map_matches_jax(monkeypatch, method, complement):
    """The uniform -> value map of the variance-reduced schemes (inverse
    CDF of discrete positions, the clamped normal inverse CDF, the
    uniform affine map, complement=) equals the JAX map on the same numpy
    uniform panels, on transship with positions of all three marginal
    types. Tolerance 1e-12 relative: two float64 ndtri implementations."""
    port = load_instance("transship", dtype=torch.float64, device="cpu")
    ref = jax_load_instance("transship", dtype=jnp.float64)
    kinds = np.array([0, 1, 2, 1, 0, 2, 1])
    vals = np.sort(np.random.default_rng(0).uniform(0, 30, (7, 3)), axis=1)
    cdf = np.tile([0.2, 0.7, 1.0], (7, 1))
    over = dict(dist_type=kinds, values=vals, cdf=cdf,
                left=np.full(7, 5.0), width=np.full(7, 20.0))
    pm = dataclasses.replace(port.scenario_model, **{
        k: torch.as_tensor(v, dtype=port.scenario_model.base.dtype
                           if v.dtype.kind == "f" else torch.int32)
        for k, v in over.items()})
    jm = dataclasses.replace(ref.scenario_model, **{
        k: jnp.asarray(v, jnp.float64 if v.dtype.kind == "f" else jnp.int32)
        for k, v in over.items()})
    rng = np.random.default_rng(1)
    u, u_z = rng.random((2, 64, 7))
    u_z[0, :3] = [0.0, 1.0, 1e-9]          # the clamp at the endpoints
    _patched_panels(monkeypatch, scenario, [u, u_z], torch.as_tensor)
    _patched_panels(monkeypatch, jax_scenario, [u, u_z], jnp.asarray)
    got = scenario.sample_values(torch.Generator(), pm, 64, method,
                                 complement=complement)
    want = jax_scenario.sample_values(jax.random.PRNGKey(0), jm, 64,
                                      method=method, complement=complement)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_stratified_and_antithetic_panels():
    """Properties of the port's own draws (tests/test_sampling.py): a
    stratified panel has one uniform per stratum and position, and its
    discrete counts are within 2 of p B; an antithetic panel pairs rows
    (u, 1 - u), so normal positions mirror around their mean; odd batches
    fall back to iid."""
    g = torch.Generator().manual_seed(4)
    u = scenario._uniform_panel(g, 256, 5, torch.float64, "cpu",
                                "stratified")
    strata = torch.sort(torch.floor(u * 256).long(), dim=0).values
    assert torch.equal(strata, torch.arange(256)[:, None].expand(256, 5))
    m = load_instance("storm", dtype=torch.float64, device="cpu").scenario_model
    v = scenario.sample_values(g, m, 256, "stratified").numpy()
    for k in range(5):
        pmf = np.diff(m.cdf[k].numpy(), prepend=0.0)
        for j, val in enumerate(m.values[k].numpy()):
            if pmf[j] > 0:
                assert abs(np.sum(np.abs(v[:, k] - val) < 1e-9)
                           - pmf[j] * 256) < 2.0
    tm = load_instance("transship", dtype=torch.float64, device="cpu").scenario_model
    a = scenario.sample_values(g, tm, 64, "antithetic").numpy()
    np.testing.assert_allclose(a[:32] + a[32:],
                               np.broadcast_to(2 * tm.mean.numpy(), (32, 7)),
                               atol=1e-9)
    assert scenario.sample_values(g, tm, 7, "antithetic").shape == (7, 7)


def test_evaluate_ci_batch_means_match_jax(monkeypatch):
    """evaluate_ci(sampling="stratified") at a fixed x on fixed delta
    panels (ten full 16-row batches, so the Student-t batch-mean width
    applies): mean and half-width equal the JAX evaluator's to 1e-8
    relative (every recourse value certified to 1e-9 in float64)."""
    cfg, jcfg = _configs()
    port = load_instance("lands", dtype=torch.float64, device="cpu")
    ref = jax_load_instance("lands", dtype=jnp.float64)
    ps = SDSolver(port, cfg, x0=_X0["lands"], seed=0)
    js = JSDSolver(ref, jcfg, x0=_X0["lands"], seed=0)
    vals = _scenario_values(port, 160, seed=24).reshape(10, 16, -1)
    panels = vals - port.scenario_model.base.numpy()
    feeds = {driver: (torch.as_tensor, itertools.cycle(panels)),
             jax_driver: (jnp.asarray, itertools.cycle(panels))}
    for mod, (conv, it) in feeds.items():
        monkeypatch.setattr(mod, "sample_deltas",
                            lambda *a, conv=conv, it=it, **k: conv(next(it)))
    x = np.array([2.0, 4.0, 3.0, 3.0])
    kw = dict(min_samples=160, max_samples=160, batch=16,
              sampling="stratified")
    mean, hw, n = ps.evaluate_ci(x=x, **kw)
    jmean, jhw, jn = js.evaluate_ci(x=x, **kw)
    assert n == jn == 160
    assert mean == pytest.approx(jmean, rel=1e-8)
    assert hw == pytest.approx(jhw, rel=1e-8)
    iid_hw = ps.evaluate_ci(x=x, **dict(kw, sampling="iid"))[1]
    assert hw != pytest.approx(iid_hw, rel=1e-3)
