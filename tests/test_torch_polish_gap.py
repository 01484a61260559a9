"""The port's certified-gap stopping (``SDReplications.solve_to_certified_gap``)
and the CLI's periodic loop and certification flags, on lands in float64
on the CPU.

The stopping run draws its own streams, which torch cannot share with the
JAX package, so these tests hold the port to the reference's semantics
and to its own routes: each look's lower bound is the route's bound at
the per-look confidence, on the states of that look.
"""

import json
import re
import warnings

import numpy as np
import pytest
import torch

import sqlp_tpu_torch.sd.driver as driver
import sqlp_tpu_torch.sd.lower_bound as lb
from sqlp_tpu_torch.cli import main
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.driver import SDReplications

torch.set_num_threads(1)

LANDS_OPT = 381.8533333
_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)
_KEYS = {"it", "route", "wall_s", "lb_cert", "lb_mean", "lb_half_width",
         "compromise_mc_ub", "compromise_mc_ub_half_width",
         "mc_ub_samples", "cert_gap", "stopped", "iters", "target_gap",
         "confidence", "time_to_certified_gap_s", "x_compromise", "rounds"}
# shared by the CLI runs: small capacities, float64, no progress lines
_CLI = ["--device", "cpu", "--dtype", "float64", "--max-scenarios", "64",
        "--max-duals", "64", "--max-cuts", "16", "--log-every", "0"]


def _reps():
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    return SDReplications(inst, SDConfig(**_CAP), n_replications=2,
                          x0=np.full(4, 3.0), seed=0)


def test_solve_to_certified_gap_splits_confidence_over_looks(monkeypatch):
    """Two planned looks (20 iterations, one every 10) under the model
    route: both run, each look's bound is the model route's bound at
    confidence 1 - 0.05 / 2 on the states of that look, and the result
    carries the reference's keys plus ``looks`` and
    ``confidence_per_look``."""
    seen = []

    def spy(arrays, espec, states, obj_scale=1.0, confidence=0.95):
        seen.append((arrays, espec, states, obj_scale, confidence))
        return lb.certified_lower_bound(arrays, espec, states,
                                        obj_scale=obj_scale,
                                        confidence=confidence)

    monkeypatch.setattr(driver, "certified_lower_bound", spy)
    s = _reps()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = s.solve_to_certified_gap(
            1e-6, max_iters=20, certify_every=10, method="model",
            min_ub_samples=1024, max_ub_samples=1024)
    assert _KEYS <= set(out)
    assert out["looks"] == 2
    assert out["confidence_per_look"] == pytest.approx(1 - 0.05 / 2)
    # no escalation: the model route's bound has the look's whole share
    assert out["lb_confidence_per_look"] == out["confidence_per_look"]
    assert not out["stopped"] and out["time_to_certified_gap_s"] is None
    assert out["iters"] == 20 and len(out["rounds"]) == 2
    assert [r["it"] for r in out["rounds"]] == [10, 20]
    assert len(seen) == 2
    for rec, (arrays, espec, states, scale, conf) in zip(out["rounds"],
                                                         seen):
        assert rec["route"] == "model"
        assert conf == pytest.approx(0.975)
        ref = lb.certified_lower_bound(arrays, espec, states,
                                       obj_scale=scale, confidence=0.975)
        assert rec["lb_cert"] == ref["lb_cert"]
        assert rec["lb_half_width"] == ref["lb_half_width"]


def test_solve_to_certified_gap_halves_the_lower_bound_share(monkeypatch):
    """A look that may escalate takes the better of two lower bounds, and
    the better one fails when either does: both routes then run at
    1 - 0.05 / (2 L), so the look's three one-sided failures (two lower
    bounds, the upper bound) sum to 0.05 / L. Two looks here, each
    escalating (the target is out of reach); the escalated route is a
    spy that returns the model route's bound."""
    seen = []

    def model(arrays, espec, states, obj_scale=1.0, confidence=0.95):
        seen.append(("model", confidence))
        return lb.certified_lower_bound(arrays, espec, states,
                                        obj_scale=obj_scale,
                                        confidence=confidence)

    def escalated(self, confidence=0.95, method="ef", **kw):
        seen.append((method, confidence))
        return lb.certified_lower_bound(self.arrays, self.espec,
                                        self.states,
                                        obj_scale=self.obj_scale,
                                        confidence=confidence)

    monkeypatch.setattr(driver, "certified_lower_bound", model)
    monkeypatch.setattr(SDReplications, "certified_lower_bound", escalated)
    s = _reps()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = s.solve_to_certified_gap(
            1e-6, max_iters=20, certify_every=10, method="polish",
            min_ub_samples=1024, max_ub_samples=1024)
    assert out["looks"] == 2 and not out["stopped"]
    assert out["confidence_per_look"] == pytest.approx(1 - 0.05 / 2)
    assert out["lb_confidence_per_look"] == pytest.approx(1 - 0.05 / 4)
    assert [m for m, _ in seen] == ["model", "polish"] * 2
    assert all(c == pytest.approx(1 - 0.05 / 4) for _, c in seen)


def test_solve_to_certified_gap_stops_through_polish():
    """A target the free model route misses after 10 iterations: the
    polish route over fresh streams certifies it at the first look, well
    before max_iters, with a bracket around the lands optimum."""
    s = _reps()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = s.solve_to_certified_gap(
            0.05, max_iters=20, certify_every=10, method="polish",
            min_ub_samples=1024, max_ub_samples=1024, polish_rounds=4,
            fresh_scenarios=256)
    assert out["stopped"] and out["iters"] == 10
    assert out["route"] in ("model", "polish")
    assert out["cert_gap"] <= 0.05
    assert out["time_to_certified_gap_s"] is not None
    assert out["lb_cert"] <= LANDS_OPT + 1e-3
    assert out["compromise_mc_ub"] + out["compromise_mc_ub_half_width"] \
        >= out["lb_cert"]


@pytest.mark.parametrize("gap", [0.0, -0.1])
def test_solve_to_certified_gap_rejects_nonpositive_target(gap):
    with pytest.raises(ValueError, match="target_gap"):
        _reps().solve_to_certified_gap(gap, max_iters=10)


def test_cli_target_gap_json(capsys):
    """--target-gap ends with the JSON record; the first look certifies
    through the model or the polish route."""
    rc = main(["solve", "lands", *_CLI, "--replications", "2", "--iters",
               "20", "--target-gap", "0.1", "--certify-every", "10",
               "--certify-scenarios", "128", "--eval-samples", "1024"])
    out = capsys.readouterr().out
    assert rc == 0, out
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["rounds"][0]["route"] in ("model", "polish")
    assert rec["looks"] == 2 and rec["stopped"]
    assert rec["cert_gap"] <= 0.1
    assert "x_compromise" in out


def test_cli_certify_polish(capsys):
    """--certify --certify-method polish prints a certified bound below
    the decision's ub + hw."""
    rc = main(["solve", "lands", *_CLI, "--replications", "2", "--iters",
               "12", "--certify", "--certify-method", "polish",
               "--certify-scenarios", "64", "--eval-samples", "256"])
    out = capsys.readouterr().out
    assert rc == 0, out
    m = re.search(r"lb_cert=(\S+) .*\ncert_gap=(\S+) \(ub (\S+)\+-(\S+),",
                  out)
    assert m, out
    lb_cert, gap, ub, hw = map(float, m.groups())
    assert np.isfinite([lb_cert, gap, ub, hw]).all()
    assert lb_cert < ub + hw


def test_cli_sharpen_cadence(capsys):
    """--eval-every 30 --sharpen-every 40 sharpens at iterations 40 and
    80 exactly (the reference's single chunk period of 30 would sharpen
    at 120 only, and not at the final iteration), and evaluates at every
    multiple of 30."""
    rc = main(["solve", "lands", *_CLI, "--iters", "120", "--eval-every",
               "30", "--sharpen-every", "40", "--eval-samples", "256",
               "--seed", "2", "--master-iters", "250", "--sub-tol",
               "1e-3"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    sharpened = [int(m) for m in
                 re.findall(r"iter (\d+): sharpened", cap.err)]
    assert sharpened == [40, 80]
    evaluated = [int(m) for m in re.findall(r"iter (\d+): mc_ub=", cap.err)]
    assert evaluated == [30, 60, 90, 120]
    assert "mc_ub=" in cap.out


def test_cli_stall_rule_stops_early(capsys):
    """--stop-stall-window stops the run once the incumbent estimate has
    moved less than --stop-stall-tol over the window."""
    rc = main(["solve", "lands", *_CLI[:-2], "--iters", "200",
               "--log-every", "5", "--stop-stall-window", "3",
               "--stop-stall-tol", "0.05", "--eval-samples", "256"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    m = re.search(r"stopping rule: incumbent estimate stabilized at iter "
                  r"(\d+)", cap.err)
    assert m, cap.err
    it = int(m.group(1))
    assert 15 <= it < 200 and it % 5 == 0
    assert re.search(rf"done: {it} iters", cap.err)


def test_cli_target_gap_needs_replications(capsys):
    """--target-gap on a single run exits 2 before any work (the reference
    ignores the flag there)."""
    assert main(["solve", "lands", "--device", "cpu", "--target-gap",
                 "0.05"]) == 2
    assert "--replications R > 1" in capsys.readouterr().err


def test_cli_stop_gap_needs_eval_every(capsys):
    """--stop-gap without --eval-every is ignored with a message, as in
    the reference."""
    rc = main(["solve", "lands", *_CLI, "--iters", "4", "--stop-gap",
               "0.5", "--eval-samples", "64"])
    cap = capsys.readouterr()
    assert rc == 0
    assert "--stop-gap needs --eval-every" in cap.err
    assert re.search(r"done: 4 iters", cap.err)
