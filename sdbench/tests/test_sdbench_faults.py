"""The check catches the faults a cell can have, and the control.

Each fault test drives a whole run of a cell on the CPU at a small size
(the program's plain versions; the harness's look for a card is skipped),
with the timed path broken underneath, and sees ``correct`` come out
false; the unbroken run beside it comes out true. The cells run on one
card, so there is no exchange between cards to leave out.
"""

import numpy as np
import pytest
import torch

from sdbench import harness, reference, smps
from sdbench.entries import mc_ub
from sdbench.sampler import Sampler

SEED = 2**31 + 4242
MC_CELLS = ("ssn.mc_ub", "storm.mc_ub")


def _mc_cell(name):
    cell = harness.load_cell(name)
    cell.workload["params"].update(panel=24, check_rows=12,
                                   pool_panels=2)
    return cell


def _ef_cell():
    cell = harness.load_cell("ssn.ef_cert")
    cell.workload["params"].update(replications=4, scenarios=24,
                                   check_rounds=3, rounds_per_call=40)
    return cell


def _run(cell, seconds=0.3):
    torch.set_num_threads(4)
    return harness.run_cell(cell, seed=SEED, seconds=seconds, trace=False,
                            device="cpu")


def _stale_solve(lp, H, config, Y0=None, L0=None, Q=None):
    """A solve whose rounds return their state unchanged: the starting
    iterate (zero, clipped to the bounds), reported as certified."""
    B = H.shape[0]
    Y = torch.clamp(torch.zeros(B, lp.n, dtype=lp.K.dtype), lp.lb, lp.ub)
    Y = Y * lp.col_scale[None, :]
    obj = Y @ (lp.q / lp.col_scale)
    Pi = torch.zeros(B, lp.m, dtype=lp.K.dtype)
    return obj, Y, Pi, {"pdhg_rounds": 1,
                        "pdhg_err": torch.zeros(B, dtype=lp.K.dtype),
                        "pdhg_valid": torch.ones(B, dtype=torch.bool)}


def _late_rows(solve, lp, H, config, **kw):
    """The rows still live once no more than a quarter of the panel is:
    those that the compaction ladder's smaller rungs finish (at the
    cell's size; here found by rerunning the solve for fewer rounds)."""
    import dataclasses
    lo, hi = 1, max(1, config.max_iters // config.restart_every)
    while lo < hi:
        k = (lo + hi) // 2
        cfg = dataclasses.replace(config, max_iters=k * config.restart_every)
        live = ~solve(lp, H, cfg, **kw)[3]["pdhg_done"]
        if int(live.sum()) <= H.shape[0] // 4:
            hi = k
        else:
            lo = k + 1
    cfg = dataclasses.replace(config, max_iters=lo * config.restart_every)
    return ~solve(lp, H, cfg, **kw)[3]["pdhg_done"]


def _late_rows_solve(fault):
    """A panel solve whose late rows come back wrong: their values
    altered by 1e-3 (``late_rows_altered``), or reported uncertified so
    that the ladder re-solves them, and the re-solve's values altered
    (``ladder_altered``)."""
    from sqlp_tpu_torch.sd import driver
    real = driver.solve_batch
    first = {}

    def solve(lp, H, config, **kw):
        obj, Y, Pi, st = real(lp, H, config, **kw)
        if not first:
            first["H"] = H
            late = _late_rows(real, lp, H, config, **kw)
            assert 0 < int(late.sum()) <= H.shape[0] // 4
            if fault == "late_rows_altered":
                obj = torch.where(late, obj * (1.0 + 1e-3), obj)
            else:
                st = dict(st, pdhg_valid=st["pdhg_valid"] & ~late)
        elif fault == "ladder_altered":
            obj = obj * (1.0 + 1e-3)
        return obj, Y, Pi, st

    def recourse(self, H, *a, **k):
        first.clear()
        return real_objs(self, H, *a, **k)
    real_objs = driver.SDSolver._recourse_objs
    return solve, recourse


@pytest.mark.parametrize("name", MC_CELLS)
def test_mc_sound_run_is_correct(name):
    res = _run(_mc_cell(name))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", MC_CELLS)
@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "answer_altered", "late_rows_altered",
                                   "ladder_altered"])
def test_mc_fault_is_caught(name, fault, monkeypatch):
    from sqlp_tpu_torch.sd import driver
    if fault == "stale_state":
        monkeypatch.setattr(driver, "solve_batch", _stale_solve)
    elif fault in ("late_rows_altered", "ladder_altered"):
        solve, recourse = _late_rows_solve(fault)
        monkeypatch.setattr(driver, "solve_batch", solve)
        monkeypatch.setattr(driver.SDSolver, "_recourse_objs", recourse)
    else:
        real = driver.SDSolver._recourse_objs

        def broken(self, H, *a, **k):
            if fault == "half_batch":
                half = H.shape[0] // 2
                v = real(self, H[:half], *a, **k)
                return np.concatenate([v, np.full(H.shape[0] - half,
                                                  v.mean())])
            return real(self, H, *a, **k) * (1.0 + 1e-3)
        monkeypatch.setattr(driver.SDSolver, "_recourse_objs", broken)
    res = _run(_mc_cell(name))
    assert not res["correct"], res["checks"]


def test_ef_sound_run_is_correct():
    res = _run(_ef_cell(), seconds=0.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["stale_state", "stale_warm",
                                   "half_batch", "answer_altered"])
def test_ef_fault_is_caught(fault, monkeypatch):
    from sqlp_tpu_torch.models import crash
    real = crash.solve_extensive_form
    prev = []

    def broken(arrays, model, deltas, probs, config, **kw):
        if fault == "stale_warm" and kw.get("x0") is not None:
            # a warm-started call hands back the state it was given
            return prev[-1]
        out = list(real(arrays, model, deltas, probs, config, **kw))
        prev.append(tuple(out))
        if fault == "stale_state":
            # the rounds hand back the state they were given
            if kw.get("x0") is None:
                out[0] = torch.zeros_like(out[0])
            else:
                out[0] = kw["x0"].clone()
        elif fault == "half_batch":
            half = out[0].shape[0] // 2
            out[0][half:] = out[0][:half].mean(0)
            out[1][half:] = out[1][:half].mean()
        elif fault == "answer_altered":
            out[1] = out[1] * (1.0 + 1e-3)
        return tuple(out)
    monkeypatch.setattr(crash, "solve_extensive_form", broken)
    res = _run(_ef_cell(), seconds=0.5)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", MC_CELLS)
def test_mc_control_fails(name):
    """The reference in TF32 in the program's place fails the check."""
    cell = _mc_cell(name)
    data = harness.instance_dir(cell.config)
    lp = smps.read_two_stage(data)
    disc = smps.read_discrete(data, lp)
    x = mc_ub._point(lp, cell.params["x"])
    g = torch.Generator()
    g.manual_seed(SEED)
    D = Sampler(disc, "cpu").iid(g, 12).numpy()
    H_ref = reference.scenario_rhs(lp, disc, D, x)
    v_ref = reference.recourse_values(lp, H_ref)
    from sdbench.control import control_panel
    lim = cell.params["limits"]
    H, v, Y, Pi, err = control_panel(lp, disc, D, x)
    every = np.ones(len(v), bool)
    for cert in (every, ~every):
        checks = mc_ub.checks(lp, H, v, H_ref, v_ref, cert, Y[cert],
                              Pi[cert], err[cert], lim)
        assert not all(c.ok for c in checks), checks
    # and the reference in its own place passes
    v_r, Y_r, Pi_r = reference.recourse_values(lp, H_ref, solutions=True)
    Pi_r = Pi_r / reference.objective_scale(lp)
    err_r = reference.kkt_errors(lp, H_ref, Y_r, Pi_r)
    for cert in (every, ~every):
        assert all(c.ok for c in mc_ub.checks(
            lp, H_ref, v_r, H_ref, v_ref, cert, Y_r[cert], Pi_r[cert],
            err_r[cert], lim))


def test_ef_control_fails():
    """The EF reference with TF32 products fails the EF check."""
    from sdbench.ef_reference import EF
    from sdbench.entries import ef_cert
    cell = _ef_cell()
    data = harness.instance_dir(cell.config)
    lp = smps.read_two_stage(data)
    disc = smps.read_discrete(data, lp)
    g = torch.Generator()
    g.manual_seed(SEED)
    s = Sampler(disc, "cpu")
    D = torch.stack([s.lhs(g, 24) for _ in range(4)])
    rounds = cell.params["check_rounds"]
    x_r, o_r, _, _ = EF(lp, disc, D).solve(rounds)
    x_c, o_c, _, _ = EF(lp, disc, D, torch.float32, tf32=True).solve(rounds)
    checks = ef_cert.gaps("start", x_c.double(), o_c.double(), x_r, o_r,
                          cell.params["limits"])
    assert not all(c.ok for c in checks), checks
