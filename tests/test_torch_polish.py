"""The port's level-bundle polish, the ef_polish route, antithetic
certification pairing, the decision polish, host dual sharpening and the
stopping rules, against the JAX package on the same states and the same
numpy streams, in float64 on the CPU.

Torch cannot draw JAX's streams, so the certification streams enter both
packages through their ``_certification_streams`` and the decision
polish's panel through their ``sample_deltas``; the SD states are the JAX
package's, carried across with ``state_from_numpy`` / ``stack_states``.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.models.scenario as jax_scenario
import sqlp_tpu.sd.lower_bound as jax_lb
import sqlp_tpu_torch.sd.compromise as compromise
import sqlp_tpu_torch.sd.lower_bound as lb
from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.config import QPConfig as JQPConfig
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.driver import SDReplications as JSDReplications
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu.sd.stopping import GapRule as JGapRule
from sqlp_tpu.sd.stopping import LowerBoundStabilization as JStab
from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.routines import project_first_stage
from sqlp_tpu_torch.models.scenario import sample_deltas
from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver
from sqlp_tpu_torch.sd.state import stack_states
from sqlp_tpu_torch.sd.stopping import GapRule, LowerBoundStabilization

from test_torch_lower_bound import _CAP, _X0, R, _solvers, _streams
from test_torch_slice import _scenario_values

torch.set_num_threads(1)

N_CERT = 64
# the EF budget of tests/test_torch_lower_bound.py: one chunk of the
# reference's chunked driver
_EF = dict(refine_iters=2048)


@pytest.fixture(scope="module")
def lands():
    return _solvers("lands", 20)


@pytest.fixture(scope="module")
def streams(lands):
    return _streams(lands[0].inst, N_CERT, seed=11)


def _inject(monkeypatch, deltas):
    """The same numpy certification streams in both packages."""
    for mod in (lb, jax_lb):
        monkeypatch.setattr(
            mod, "_certification_streams",
            lambda *a, **k: (deltas, np.ones(deltas.shape[:3]), False))


def _replications(lands):
    """An SDReplications of each package holding the carried states."""
    ps, js, states = lands
    s = SDReplications(ps.inst, SDConfig(**_CAP), n_replications=R,
                       x0=_X0["lands"], seed=0)
    s.state = stack_states(states)
    j = JSDReplications(js[0].inst, JSDConfig(**_CAP), n_replications=R,
                        x0=_X0["lands"], seed=0)
    j.state = jax.tree.map(lambda *xs: jnp.stack(xs), *[x.state for x in js])
    return s, j


@pytest.fixture(scope="module")
def polish_pair(lands, streams):
    """saa_polish in both packages: lands, R = 2, 64-scenario streams,
    3 rounds."""
    ps, js, states = lands
    mp = pytest.MonkeyPatch()
    _inject(mp, streams)
    kw = dict(fresh_scenarios=N_CERT, max_rounds=3)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = jax_lb.saa_polish(
                js[0].arrays, js[0].scenario_model, js[0].espec,
                js[0].prep_sub, [j.state for j in js], js[0].config,
                obj_scale=js[0].obj_scale, **kw)
            got = lb.saa_polish(ps.arrays, ps.scenario_model, ps.espec,
                                ps.prep_sub, states, ps.config,
                                obj_scale=ps.obj_scale, **kw)
    finally:
        mp.undo()
    return ref, got


def _check_cuts(got_cuts, ref_cuts, n=None):
    for g, r in zip(got_cuts[:n], ref_cuts[:n]):
        assert g[0] == r[0]
        assert g[1] == pytest.approx(r[1], rel=1e-6, abs=1e-6)
        np.testing.assert_allclose(g[2], r[2], rtol=1e-6, atol=1e-6)


def test_saa_polish_matches_jax(polish_pair):
    """Round 1 (the incumbents, one cut per replication) and the SAA
    value estimates at 1e-6 relative: the same f64 arithmetic up to
    reduction order. Later rounds evaluate the projection QP's point; an
    ADMM solve that ends on a near-tie could move it, so the final bounds
    are held at 1e-6 relative too but the round count only to equality
    of the stopping test (the same on this input in both)."""
    ref, got = polish_pair
    for r in range(R):
        _check_cuts(got["cuts_per_rep"][r], ref["cuts_per_rep"][r], n=1)
    np.testing.assert_allclose(got["saa_ub_per_rep"], ref["saa_ub_per_rep"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["lb_per_rep"], ref["lb_per_rep"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["gap_per_rep"], ref["gap_per_rep"],
                               rtol=1e-4, atol=1e-9)
    assert got["rounds"] == ref["rounds"] == 3
    assert got["n_scenarios"] == ref["n_scenarios"] == N_CERT
    for r in range(R):
        assert len(got["cuts_per_rep"][r]) == len(ref["cuts_per_rep"][r])
        _check_cuts(got["cuts_per_rep"][r], ref["cuts_per_rep"][r])
    np.testing.assert_allclose(got["dual_infeas_per_rep"],
                               ref["dual_infeas_per_rep"], atol=1e-12)
    # a valid bound sits below the bundle's SAA value estimate
    assert np.all(got["lb_per_rep"] <= got["saa_ub_per_rep"] + 1e-9)


def test_saa_lower_bound_on_the_sd_stream_matches_jax(lands):
    """SDSolver.saa_lower_bound: the polish on the run's own 20-scenario
    stream, where the SD cuts stay in the bound model (the other tests
    inject fresh streams, which take them out). Bounds and SAA estimates
    at 1e-6 relative, the round count equal."""
    ps, js, states = lands
    s = SDSolver(ps.inst, SDConfig(**_CAP), x0=_X0["lands"], seed=0)
    s.state = states[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = js[0].saa_lower_bound(max_rounds=3)
        got = s.saa_lower_bound(max_rounds=3)
    assert got["n_scenarios"] == ref["n_scenarios"] == 20
    for k in ("lb_per_rep", "saa_ub_per_rep"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert got["rounds"] == ref["rounds"]
    # the SD cuts alone already bound the model: the polish only adds
    assert got["lb_per_rep"][0] >= s.cut_model_lower_bound() - 1e-6


def test_saa_polish_rejects_bad_inputs(lands):
    ps, _, states = lands
    with pytest.raises(ValueError, match="qp_rows_cap"):
        lb.saa_polish(ps.arrays, ps.scenario_model, ps.espec, ps.prep_sub,
                      states, ps.config, qp_rows_cap=1, fresh_scenarios=8)
    bad = [states[0], dataclasses.replace(states[1],
                                          n_scen=states[1].n_scen + 1)]
    with pytest.raises(ValueError, match="scenario counts"):
        lb.saa_polish(ps.arrays, ps.scenario_model, ps.espec, ps.prep_sub,
                      bad, ps.config, fresh_scenarios=8)


@pytest.fixture(scope="module")
def ef_polish_pair(lands, streams):
    """The ef_polish route in both packages and the port's plain ef route,
    all on the same injected streams."""
    s, j = _replications(lands)
    mp = pytest.MonkeyPatch()
    _inject(mp, streams)
    kw = dict(fresh_scenarios=N_CERT, polish_rounds=3, **_EF)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = j.certified_lower_bound(
                method="ef_polish",
                ef_config=JPDHGConfig(tol=1e-5, max_iters=16_000), **kw)
            got = s.certified_lower_bound(
                method="ef_polish",
                ef_config=PDHGConfig(tol=1e-5, max_iters=16_000), **kw)
            plain = s.certified_lower_bound(
                method="ef", fresh_scenarios=N_CERT,
                ef_config=PDHGConfig(tol=1e-5, max_iters=16_000), **_EF)
    finally:
        mp.undo()
    return ref, got, plain


def test_ef_polish_route_matches_jax(ef_polish_pair):
    """The merged bound and the polish's own bound equal the JAX
    package's (1e-6 of the bound's scale, the EF test's tolerance); the
    merged bound is never below the polish's (the invariant of
    tests/test_certified_bound.py:426) nor below the plain EF route's on
    the same streams (the cuts are only more)."""
    ref, got, plain = ef_polish_pair
    for k in ("lb_per_rep", "polish_lb_per_rep"):
        scale = 1.0 + np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
    for k in ("lb_cert", "lb_mean"):
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    assert got["polish_rounds"] == ref["polish_rounds"]
    assert np.all(got["lb_per_rep"] >= got["polish_lb_per_rep"] - 1e-6)
    assert np.all(got["lb_per_rep"] >= plain["lb_per_rep"] - 1e-6)
    assert "x_ef_per_rep" in got and "ef_obj_per_rep" in got


def test_polish_route_via_replications(lands, streams, monkeypatch):
    """method="polish" through SDReplications equals the JAX package's
    route on the same streams."""
    s, j = _replications(lands)
    _inject(monkeypatch, streams)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.certified_lower_bound(method="polish", polish_rounds=2,
                                      fresh_scenarios=N_CERT)
        got = s.certified_lower_bound(method="polish", polish_rounds=2,
                                      fresh_scenarios=N_CERT)
    np.testing.assert_allclose(got["lb_per_rep"], ref["lb_per_rep"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["saa_ub_per_rep"], ref["saa_ub_per_rep"],
                               rtol=1e-6)
    assert got["polish_rounds"] == ref["polish_rounds"]
    assert got["lb_cert"] == pytest.approx(ref["lb_cert"], rel=1e-6)


def test_antithetic_streams_pair_replications(lands):
    """Replication 2k+1's certification deltas are the complement of
    replication 2k's, drawn from stream k * E + e."""
    ps, _, states = lands
    states4 = states + states
    d, w, inc = lb._certification_streams(
        states4, ps.scenario_model, 4, 1, 20, 0, 32, 9000, "stratified",
        "antithetic")
    assert d.shape == (4, 1, 32, ps.scenario_model.n_rv) and not inc
    np.testing.assert_array_equal(w, np.ones((4, 1, 32)))
    sm = ps.scenario_model
    for k in range(2):
        gen = lambda: lb.stream_generator(sm.base.device, 9000, k)
        first = sample_deltas(gen(), sm, 32, method="stratified")
        second = sample_deltas(gen(), sm, 32, method="stratified",
                               complement=True)
        np.testing.assert_array_equal(d[2 * k, 0], first.numpy())
        np.testing.assert_array_equal(d[2 * k + 1, 0], second.numpy())
    assert not np.allclose(d[0], d[1])
    with pytest.raises(ValueError, match="even R"):
        lb._certification_streams(states4[:3], sm, 3, 1, 20, 0, 32, 9000,
                                  "stratified", "antithetic")


def test_antithetic_reps_keep_every_replication(lands):
    """certified_lower_bound(antithetic_reps=True): lb_per_rep keeps the
    R per-replication bounds (the reference returns R/2 there); the
    interval is t_lower_bound(pair_means=True) of them, whose pair means
    come back as lb_pair_means. An odd R, no fresh streams or the model
    route raise ValueError."""
    ps, _, states = lands
    s = SDReplications(ps.inst, SDConfig(**_CAP), n_replications=4,
                       x0=_X0["lands"], seed=0)
    s.state = stack_states(states + states)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = s.certified_lower_bound(method="polish", polish_rounds=2,
                                      fresh_scenarios=32,
                                      antithetic_reps=True)
    assert out["lb_per_rep"].shape == (4,)
    assert out["saa_ub_per_rep"].shape == (4,)
    ref = lb.t_lower_bound(out["lb_per_rep"], pair_means=True)
    for k in ("lb_cert", "lb_mean", "lb_half_width"):
        assert out[k] == ref[k], k
    assert np.isfinite(out["lb_cert"])
    np.testing.assert_array_equal(out["lb_pair_means"], ref["lb_per_rep"])
    assert out["n_replications"] == 2
    with pytest.raises(ValueError, match="fresh_scenarios"):
        s.certified_lower_bound(method="ef", antithetic_reps=True)
    with pytest.raises(ValueError, match="model route"):
        s.certified_lower_bound(method="model", antithetic_reps=True,
                                fresh_scenarios=8)
    odd = SDReplications(s.inst, SDConfig(**_CAP), n_replications=3,
                         x0=_X0["lands"], seed=0)
    with pytest.raises(ValueError, match="even number"):
        odd.certified_lower_bound(method="ef", antithetic_reps=True,
                                  fresh_scenarios=8)


_POLISH_CFG = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
                   max_cuts=16)


def test_polish_decision_matches_jax(monkeypatch):
    """lands from x0 = (3, 3, 3, 3), one injected 512-scenario panel, 8
    rounds, rho 5 (tests/test_compromise.py:137-165): the per-round
    values and x_best at 1e-6 relative, the serious steps equal; the
    reference's checks hold too."""
    port = load_instance("lands", dtype=torch.float64, device="cpu")
    ref_inst = jax_load_instance("lands", dtype=jnp.float64)
    sm = port.scenario_model
    panel = (_scenario_values(port, 512, seed=7).reshape(512, -1)
             - sm.base.numpy())
    monkeypatch.setattr(
        jax_scenario, "sample_deltas",
        lambda *a, **k: jnp.asarray(panel, jnp.float64))
    monkeypatch.setattr(
        compromise, "sample_deltas",
        lambda *a, **k: torch.as_tensor(panel, dtype=torch.float64))
    x0 = np.array([3.0, 3.0, 3.0, 3.0])
    js = JSDSolver(ref_inst, JSDConfig(
        **_POLISH_CFG, pdhg=JPDHGConfig(tol=1e-7, max_iters=20_000),
        qp=JQPConfig(tol=1e-9, max_iters=4_000)), x0=x0, seed=0)
    ps = SDSolver(port, SDConfig(
        **_POLISH_CFG, pdhg=PDHGConfig(tol=1e-7, max_iters=20_000),
        qp=QPConfig(tol=1e-9, max_iters=4_000)), x0=x0, seed=0)
    xr, ir = js.polish_decision(x0, n_scenarios=512, rounds=8, rho=5.0)
    xp, ip = ps.polish_decision(x0, n_scenarios=512, rounds=8, rho=5.0)
    np.testing.assert_allclose(ip["values"], ir["values"], rtol=1e-6)
    assert ip["serious_steps"] == ir["serious_steps"]
    np.testing.assert_allclose(xp, xr, rtol=1e-6, atol=1e-6)
    assert ip["f_best"] == pytest.approx(ir["f_best"], rel=1e-6)
    v = np.asarray(ip["values"])
    assert ip["f_best"] <= v[0] - 0.5
    assert ip["f_best"] == v[ip["serious_steps"]].min()
    a = port.arrays
    assert np.all(xp >= a.lb1.numpy() - 1e-9)
    assert np.all(xp <= a.ub1.numpy() + 1e-9)
    assert project_first_stage(a, xp)[1] == 0.0


def test_sharpen_duals_host_matches_jax(lands):
    """One lands state (20 iterations) carried into both packages: the
    same scenarios re-solved, the same slacks, the same pool after the
    push."""
    ps, js, states = lands
    j = js[1]
    s = SDSolver(ps.inst, SDConfig(**_CAP), x0=_X0["lands"], seed=0)
    s.state = states[1]
    state0 = j.state
    try:
        ref = j.sharpen_duals_host(k=8)
        got = s.sharpen_duals_host(k=8)
        after = j.state
    finally:
        j.state = state0
    assert got["n_solved"] == ref["n_solved"] > 0
    assert got["n_new"] == ref["n_new"]
    for k in ("mean_slack", "max_slack"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-12), k
    nd = int(after.n_duals)
    assert int(s.state.n_duals) == nd
    np.testing.assert_array_equal(s.state.duals.numpy()[:nd],
                                  np.asarray(after.duals)[:nd])
    np.testing.assert_array_equal(s.state.duals_score.numpy()[:nd],
                                  np.asarray(after.duals_score)[:nd])
    assert int(s.state.duals_dropped) == int(after.duals_dropped)


def test_sharpen_duals_host_refuses_random_cost():
    inst = load_instance("newsprice", dtype=torch.float64, device="cpu")
    s = SDSolver(inst, SDConfig(**_CAP), seed=0)
    with pytest.raises(ValueError, match="random-cost"):
        s.sharpen_duals_host(k=4)
    with pytest.raises(ValueError, match="random-cost"):
        s.polish_decision(np.zeros(inst.n1), n_scenarios=8, rounds=1)


# tests/test_stopping.py's three unit cases, on the port's classes


def test_gap_rule_relative_semantics():
    rule = GapRule(rel_gap=0.01)
    assert not rule.check(lb_est=90.0, ub_est=100.0)
    assert rule.check(lb_est=99.5, ub_est=100.0)
    assert not rule.check(lb_est=99.5, ub_est=100.0, ub_half_width=2.0)
    assert rule.check(lb_est=-0.005, ub_est=0.0)


def test_stabilization_window():
    stab = LowerBoundStabilization(window=3, rel_tol=1e-3)
    assert not stab.update(10.0)
    assert not stab.update(11.0)
    assert not stab.update(12.0)
    assert not stab.update(12.001)
    assert stab.update(12.002)


def test_stabilization_resets_on_movement():
    stab = LowerBoundStabilization(window=2, rel_tol=1e-6)
    stab.update(5.0)
    assert stab.update(5.0)
    assert not stab.update(6.0)


def test_stopping_rules_match_jax():
    """One numpy series through both packages' rules: equal decisions
    at every step."""
    rng = np.random.default_rng(3)
    series = 100.0 + np.cumsum(rng.normal(0.0, 1.0, 200)
                               * np.exp(-np.arange(200) / 30.0))
    ub = series + np.abs(rng.normal(0.5, 0.5, 200))
    hw = np.abs(rng.normal(0.3, 0.2, 200))
    for window, tol in ((3, 1e-3), (10, 1e-4), (70, 1e-2)):
        a, b = LowerBoundStabilization(window, tol), JStab(window, tol)
        assert [a.update(v) for v in series] == \
            [b.update(v) for v in series]
    ga, gb = GapRule(5e-3), JGapRule(5e-3)
    assert [ga.check(*t) for t in zip(series, ub, hw)] == \
        [gb.check(*t) for t in zip(series, ub, hw)]
