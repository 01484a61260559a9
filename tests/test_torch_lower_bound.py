"""The port's certified lower bounds (sqlp_tpu_torch/sd/lower_bound.py and
the driver's certification methods) against the JAX package on the same
states and the same certification streams, in float64 on the CPU; the
decision selection; and the CLI's ``evaluate``, ``--certify`` and
refusals.

Torch cannot draw JAX's streams, so ``saa_ef_bound`` gets the same numpy
streams in both packages through their ``_certification_streams``."""

import dataclasses
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.sd.lower_bound as jax_lb
import sqlp_tpu_torch.sd.lower_bound as lb
from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu_torch.cli import main
from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver
from sqlp_tpu_torch.sd.state import state_from_numpy

from test_torch_slice import _scenario_values

torch.set_num_threads(1)

LANDS_OPT = 381.8533333
R = 2
_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)
_X0 = {"lands": np.full(4, 3.0), "transship": None}


def _jax_states_to_port(jstates, template):
    fields = [f.name for f in dataclasses.fields(template)]
    return [state_from_numpy({f: np.asarray(getattr(js, f)) for f in fields},
                             template) for js in jstates]


def _solvers(name, iters):
    """R JAX solvers run ``iters`` iterations (seeds 0..R-1); the port
    solver on the same instance; the JAX states carried across."""
    ref = jax_load_instance(name, dtype=jnp.float64)
    port = load_instance(name, dtype=torch.float64, device="cpu")
    js = [JSDSolver(ref, JSDConfig(**_CAP), x0=_X0[name], seed=r)
          for r in range(R)]
    for j in js:
        if iters:
            j.run(iters)
    ps = SDSolver(port, SDConfig(**_CAP), x0=_X0[name], seed=0)
    return ps, js, _jax_states_to_port([j.state for j in js], ps.state)


@pytest.fixture(scope="module")
def lands():
    return _solvers("lands", 20)


def test_cut_model_min_matches_jax(lands):
    ps, js, states = lands
    for j, s in zip(js, states):
        ref = jax_lb.cut_model_min(j.arrays, j.espec, j.state,
                                   obj_scale=j.obj_scale)
        got = lb.cut_model_min(ps.arrays, ps.espec, s,
                               obj_scale=ps.obj_scale)
        assert got == pytest.approx(ref, rel=1e-9, abs=1e-9)
        assert got > 300.0


def test_model_route_matches_jax(lands):
    ps, js, states = lands
    ref = jax_lb.certified_lower_bound(js[0].arrays, js[0].espec,
                                       [j.state for j in js],
                                       obj_scale=js[0].obj_scale)
    got = lb.certified_lower_bound(ps.arrays, ps.espec, states,
                                   obj_scale=ps.obj_scale)
    for k in ("lb_cert", "lb_mean", "lb_half_width"):
        assert got[k] == pytest.approx(ref[k], rel=1e-9, abs=1e-9), k
    for k in ("lb_per_rep", "dual_infeas_per_rep"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["fresh", "own", "extended", "overflow"])
def test_certification_streams_admissibility(lands, case):
    """Whether the SD run's own cuts may enter the bound model: only for
    the run's own full stream without reservoir overflow. The SD part of
    the streams is the states' own panel in both packages."""
    ps, js, states = lands
    jstates = [j.state for j in js]
    if case == "overflow":
        jstates = [dataclasses.replace(s, scen_dropped=jnp.asarray(
            3, s.scen_dropped.dtype)) for s in jstates]
        states = [dataclasses.replace(s, scen_dropped=torch.tensor(
            3, dtype=s.scen_dropped.dtype)) for s in states]
    fresh = 16 if case == "fresh" else 0
    extra = 8 if case == "extended" else 0
    N_sd = 20
    ref = jax_lb._certification_streams(
        jstates, js[0].scenario_model, R, 1, N_sd, extra, fresh, 9000,
        "stratified")
    got = lb._certification_streams(
        states, ps.scenario_model, R, 1, N_sd, extra, fresh, 9000,
        "stratified")
    assert got[2] == ref[2] == (case == "own")
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    if not fresh:
        np.testing.assert_array_equal(got[0][:, :, :N_sd],
                                      ref[0][:, :, :N_sd])
        np.testing.assert_array_equal(got[1], ref[1])


def _streams(inst, N, seed):
    """[R, 1, N, Rv] numpy certification deltas."""
    base = inst.scenario_model.base.numpy()
    return np.stack([(_scenario_values(inst, N, seed + r).reshape(N, -1)
                      - base)[None] for r in range(R)])


@pytest.mark.parametrize("name, opts", [
    ("lands", {}), ("transship", {}),
    ("lands", {"refine_duals": False, "host_exact_cap": 0}),
    ("lands", {"refine_f64": False})],
    ids=["lands", "transship", "lands-raw_duals", "lands-no_f64"])
def test_saa_ef_bound_matches_jax(name, opts, lands, monkeypatch):
    """R = 2 replications on injected 64-scenario streams, under the
    default dual repair and under the reference's other two options: the
    raw EF duals with no host re-solve (only the exact corrections keep
    the bound valid) and no f64 continuation. The EF budget fits one
    chunk of the reference's chunked driver (16,384 iterations in f32,
    2048 in the f64 pass), which the port does not have. Tolerances: the
    bounds, EF objectives, argmins and errors within 1e-6 of their scale
    (f64); the projected duals' infeasibility and corrections within
    1e-12; the raw duals' within 1e-9 of the EF duals' scale."""
    if name == "lands":
        ps, js, states = lands
    else:
        ps, js, states = _solvers(name, 0)
    deltas = _streams(ps.inst, 64, seed=11)
    for mod in (lb, jax_lb):
        monkeypatch.setattr(mod, "_certification_streams",
                            lambda *a, **k: (deltas, np.ones(deltas.shape[:3]),
                                             False))
    kw = dict(fresh_scenarios=64, refine_iters=2048, **opts)
    budget = 16_000 if name == "lands" else 6_400
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_lb.saa_ef_bound(
            js[0].arrays, js[0].scenario_model, js[0].espec,
            [j.state for j in js], js[0].config, obj_scale=js[0].obj_scale,
            ef_config=JPDHGConfig(tol=1e-5, max_iters=budget), **kw)
        got = lb.saa_ef_bound(
            ps.arrays, ps.scenario_model, ps.espec, states, ps.config,
            obj_scale=ps.obj_scale,
            ef_config=PDHGConfig(tol=1e-5, max_iters=budget), **kw)
    for k in ("lb_per_rep", "ef_obj_per_rep", "x_ef_per_rep",
              "ef_err_per_rep"):
        scale = 1.0 + np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6 * scale,
                                   err_msg=k)
    raw = opts.get("refine_duals") is False
    for k in ("dual_infeas_per_rep", "cut_correction_per_rep"):
        atol = 1e-9 * (1.0 + np.abs(ref[k]).max()) if raw else 1e-12
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert got["host_exact_count"] == ref["host_exact_count"]
    assert got["n_scenarios"] == ref["n_scenarios"] == 64
    assert got["n_unrefined"] == ref["n_unrefined"] == (R * 64 if raw else 0)
    if "host_exact_cap" in opts:
        assert got["host_exact_count"] == 0
    if opts.get("refine_f64") is False:
        assert not got["refine_iters_per_rep"].any()
    # valid: never above the SAA optimum the EF approximates; tight on
    # lands, while on transship the aggregate cut's small slope errors
    # over its wide first-stage box leave the model at the epigraph floor
    # (the same number in both packages)
    assert np.all(got["lb_per_rep"] <= got["ef_obj_per_rep"] * (1 + 1e-6))
    if name == "lands":
        np.testing.assert_allclose(got["lb_per_rep"], got["ef_obj_per_rep"],
                                   rtol=1e-3)


def test_saa_ef_bound_refuses_resolve(lands):
    """``refine_mode="resolve"`` is not ported (it crashes the bound to
    the epigraph floor on degenerate recourse): ValueError before any
    solve, naming the mode; an unknown mode too."""
    ps, _, states = lands
    for mode, match in (("resolve", "not ported"), ("bogus", "unknown")):
        with pytest.raises(ValueError, match=match):
            lb.saa_ef_bound(ps.arrays, ps.scenario_model, ps.espec, states,
                            ps.config, fresh_scenarios=8, refine_mode=mode)


def test_ef_refine_modes_all_valid_newsvendor():
    """The port's counterpart of the reference's
    test_ef_refine_modes_all_valid_newsvendor at its sizes (f64, R = 2,
    60 iterations, 256 fresh scenarios), without the unported
    ``resolve``: the projection, the raw duals with exact corrections and
    no host re-solve, and no f64 continuation each give a valid bound
    that stays tight at the exact optimum 1.0 on newsvendor's
    non-degenerate recourse (about 13 s on one CPU thread)."""
    inst = load_instance("newsvendor", dtype=torch.float64, device="cpu")
    cfg = SDConfig(dtype="float64", max_scenarios=256,
                   max_dual_vertices=128, max_cuts=24,
                   pdhg=PDHGConfig(tol=1e-8, max_iters=20_000),
                   qp=QPConfig(tol=1e-9, max_iters=4_000))
    s = SDReplications(inst, cfg, n_replications=2, seed=5)
    s.run(60)
    for kw in ({}, {"refine_duals": False, "host_exact_cap": 0},
               {"refine_f64": False}):
        out = lb.saa_ef_bound(s.arrays, s.scenario_model, s.espec, s.states,
                              s.config, obj_scale=s.obj_scale,
                              fresh_scenarios=256, **kw)
        assert np.all(out["lb_per_rep"] <= 1.0 + 1e-3), (kw, out)
        assert np.all(out["lb_per_rep"] >= 1.0 - 0.05), (kw, out)
        assert out["x_ef_per_rep"].shape == (2, inst.n1)
        if "host_exact_cap" in kw:
            assert out["host_exact_count"] == 0


def test_t_lower_bound_matches_jax():
    rng = np.random.default_rng(0)
    for per_rep in (rng.normal(9.8, 0.2, 8), rng.normal(381, 2, 3)):
        for pair in (False, True):
            if pair and len(per_rep) % 2:
                continue
            ref = jax_lb.t_lower_bound(per_rep, pair_means=pair)
            got = lb.t_lower_bound(per_rep, pair_means=pair)
            for k in ("lb_cert", "lb_mean", "lb_half_width"):
                assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)
            np.testing.assert_array_equal(got["lb_per_rep"],
                                          ref["lb_per_rep"])


def test_t_lower_bound_rejected_replication_is_visible():
    """A rejected certificate (-inf) gives lb_cert -inf with a warning
    naming the replication, as the reference
    (tests/test_certified_bound.py:333)."""
    with pytest.warns(UserWarning, match=r"replications \[1\]"):
        out = lb.t_lower_bound(np.array([9.5, -np.inf, 9.7]))
    ref = jax_lb.t_lower_bound(np.array([9.5, -np.inf, 9.7]))
    assert out["lb_cert"] == ref["lb_cert"] == -np.inf
    assert out["lb_mean"] == -np.inf and not np.isnan(out["lb_cert"])


def test_select_decision_picks_lowest_mean():
    """Every candidate on one shared panel; the winner has the lowest
    mean of the table and comes back projected."""
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    s = SDSolver(inst, SDConfig(**_CAP), x0=np.full(4, 3.0), seed=0)
    cand = {"low": np.array([2.0, 4.0, 3.3, 2.0]),
            "high": np.array([8.0, 1.0, 1.0, 2.0]),
            "outside": np.array([0.0, 0.0, 0.0, 0.0])}
    sel = s.select_decision(cand, n_samples=512, seed=5)
    means = {k: v[0] for k, v in sel["table"].items()}
    assert set(means) == set(cand)
    assert sel["name"] == min(means, key=means.get)
    assert sel["table"]["outside"][2] > 0.0           # projected
    again = s.evaluate_ci(x=sel["x"], min_samples=512, max_samples=512,
                          seed=5, batch=4096, sampling="stratified")
    assert again[0] == pytest.approx(means[sel["name"]], rel=1e-12)


def test_replications_certified_bound_routes(lands):
    """SDReplications.certified_lower_bound: the model route on the
    carried states equals the JAX package's; the polish routes and
    antithetic pairing run and return one valid bound per replication
    (tests/test_torch_polish.py holds them against the JAX package)."""
    ps, js, states = lands
    s = SDReplications(ps.inst, SDConfig(**_CAP), n_replications=R,
                       x0=_X0["lands"], seed=0)
    from sqlp_tpu_torch.sd.state import stack_states
    s.state = stack_states(states)
    got = s.certified_lower_bound(method="model")
    ref = jax_lb.certified_lower_bound(js[0].arrays, js[0].espec,
                                       [j.state for j in js],
                                       obj_scale=js[0].obj_scale)
    np.testing.assert_allclose(got["lb_per_rep"], ref["lb_per_rep"],
                               rtol=1e-9)
    for kw in ({"method": "polish", "polish_rounds": 2},
               {"method": "ef_polish", "polish_rounds": 2,
                "fresh_scenarios": 8, "refine_iters": 64,
                "ef_config": PDHGConfig(tol=1e-5, max_iters=4_000)},
               {"method": "polish", "polish_rounds": 2,
                "antithetic_reps": True, "fresh_scenarios": 8}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = s.certified_lower_bound(**kw)
        assert out["lb_per_rep"].shape == (R,), kw
        assert np.all(np.isfinite(out["lb_per_rep"])), kw
        assert np.all(out["lb_per_rep"] < LANDS_OPT + 60.0), kw
        if kw["method"] == "ef_polish":
            assert np.all(out["lb_per_rep"]
                          >= out["polish_lb_per_rep"] - 1e-6)


def test_cli_certify_lands(capsys):
    """solve lands --replications 2 --certify on the CPU: the certified
    bound, the selection and the gap are printed, lb_cert sits below the
    decision's ub + hw, and both near the lands optimum."""
    rc = main(["solve", "lands", "--device", "cpu", "--replications", "2",
               "--iters", "12", "--certify", "--certify-scenarios", "64",
               "--eval-samples", "256", "--log-every", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = re.search(r"lb_cert=(\S+) .*\ncert_gap=(\S+) \(ub (\S+)\+-(\S+),",
                  out)
    assert m, out
    lb_cert, gap, ub, hw = map(float, m.groups())
    assert np.isfinite([lb_cert, gap, ub, hw]).all()
    assert lb_cert < ub + hw
    assert abs(lb_cert - LANDS_OPT) < 12.0 and abs(ub - LANDS_OPT) < 12.0


def test_cli_evaluate(capsys):
    rc = main(["evaluate", "lands", "--device", "cpu", "--x",
               "3,4,3,2", "--samples", "256"])
    out = capsys.readouterr().out
    assert rc == 0
    m = re.search(r"E\[cost at x\] ~= (\S+) \(256 samples\)", out)
    assert m, out
    assert abs(float(m.group(1)) - LANDS_OPT) < 12.0


@pytest.mark.parametrize("flags", [
    ["--cpu-devices-per-process", "2"],
    ["--cpu-devices-per-process", "2", "--proposal-sto", "x"]])
def test_cli_refuses_polish_and_target_gap(flags, capsys):
    """The flag the port refuses, with the reason, alone and beside
    --proposal-sto. The polish route and --target-gap, which this test
    refused before, run now (tests/test_torch_polish_gap.py); so do
    --proposal-sto (tests/test_torch_run_management.py) and --mesh
    (tests/test_torch_distributed.py)."""
    assert main(["solve", "lands", "--device", "cpu", *flags]) == 2
    err = capsys.readouterr().err
    assert "is not ported to sqlp_tpu_torch: torch has no virtual" in err
