"""The port's extensive-form solver (sqlp_tpu_torch/models/crash.py) against
the JAX package's on the same numpy scenario panels, in float64 on the CPU:
the lands golden, a seeded transship panel (no first-stage rows), a
scenario model whose random positions repeat a row, a warm start, the
replication-batched solve against single solves, and ``crash_x0``."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.models.crash import solve_extensive_form as jax_ef
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu_torch.cli import main
from sqlp_tpu_torch.config import PDHGConfig
from sqlp_tpu_torch.models.crash import crash_x0, solve_extensive_form
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.scenario import (SCENARIO_FIELDS,
                                            scenario_model_from_numpy)

from test_torch_slice import _scenario_values

torch.set_num_threads(1)

LANDS_OPT = 381.8533333


def _pair(name):
    return (load_instance(name, dtype=torch.float64, device="cpu"),
            jax_load_instance(name, dtype=jnp.float64))


def _deltas(inst, S, seed):
    """[S, Rv] deltas of S scenarios drawn by numpy from the marginals."""
    vals = _scenario_values(inst, S, seed).reshape(S, -1)
    return vals - inst.scenario_model.base.numpy()


def _both(port, ref, deltas, probs, tol, max_iters, port_model=None,
          ref_model=None, warm=(None, None)):
    """The same EF through both packages with return_duals; ``warm`` is
    (port warm-start kwargs, JAX warm-start kwargs)."""
    out = solve_extensive_form(
        port.arrays, port_model or port.scenario_model,
        torch.as_tensor(deltas), torch.as_tensor(probs),
        PDHGConfig(tol=tol, max_iters=max_iters), return_duals=True,
        **(warm[0] or {}))
    jout = jax_ef(ref.arrays, ref_model or ref.scenario_model,
                  jnp.asarray(deltas), jnp.asarray(probs),
                  JPDHGConfig(tol=tol, max_iters=max_iters),
                  return_duals=True, **(warm[1] or {}))
    return out, jout


def _assert_same(out, jout, restart_every=80):
    """Objective to 1e-8 relative, x to 1e-6 absolute, the iteration count
    within one restart round, and the duals, second-stage blocks and
    stage-1 duals to 1e-6 of their scale."""
    x, obj, st, duals, Y, u0 = out
    jx, jobj, jst, jduals, jY, ju0 = jout
    assert float(obj) == pytest.approx(float(jobj), rel=1e-8)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    assert abs(int(st["ef_iters"]) - int(jst["ef_iters"])) <= restart_every
    assert bool(st["ef_converged"]) == bool(jst["ef_converged"])
    for a, b in ((duals, jduals), (Y, jY), (u0, ju0)):
        b = np.asarray(b)
        scale = 1.0 + np.abs(b).max(initial=0.0)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * scale)


def test_lands_extensive_form_golden():
    """The 3-scenario lands deterministic equivalent (p = .3/.4/.3) at the
    reference's golden 381.8533333 (tests/test_crash.py:18-37), equal to
    the JAX solve."""
    port, ref = _pair("lands")
    base = float(port.scenario_model.base[0])
    deltas = np.array([[3.0 - base], [5.0 - base], [7.0 - base]])
    probs = np.array([0.3, 0.4, 0.3])
    out, jout = _both(port, ref, deltas, probs, 1e-6, 100_000)
    assert bool(out[2]["ef_converged"])
    assert float(out[1]) == pytest.approx(LANDS_OPT, abs=2e-3)
    x = out[0].numpy()
    A1 = port.arrays.A1.numpy()
    b1 = port.arrays.b1.numpy()
    s1 = port.arrays.senses1.numpy()
    lhs = A1 @ x
    assert np.all(lhs[s1 == 1] >= b1[s1 == 1] - 1e-4)
    assert np.all(lhs[s1 == -1] <= b1[s1 == -1] + 1e-4)
    _assert_same(out, jout)


def test_transship_matches_jax():
    """8 seeded transship scenarios (no first-stage rows: the empty A1
    path) to tol 1e-6."""
    port, ref = _pair("transship")
    deltas = _deltas(port, 8, seed=3)
    out, jout = _both(port, ref, deltas, np.full(8, 1 / 8), 1e-6, 40_000)
    assert bool(out[2]["ef_converged"])
    _assert_same(out, jout)


def _repeated_rows(port, ref):
    """farmer's scenario model with three positions appended so that rows
    repeat: an RHS position on the row of a transfer position, a second
    transfer position on that row (another column), and a second RHS
    position on the row of the existing one. Both scatter-adds (the
    right-hand side and the transfer operator) then see repeated
    indices."""
    sm = port.scenario_model
    f = {k: getattr(sm, k).numpy() for k in SCENARIO_FIELDS}
    extra = {"rv_row": [0, 0, 1], "rv_is_rhs": [True, False, True],
             "rv_col": [0, 1, 0], "rv_is_cost": [False, False, False],
             "rv_ycol": [0, 0, 0]}
    for k in SCENARIO_FIELDS:
        if k in extra:
            f[k] = np.concatenate([f[k], np.asarray(extra[k], f[k].dtype)])
        elif k != "seed_dual":
            f[k] = np.concatenate([f[k], f[k][-1:].repeat(3, axis=0)])
    pm = scenario_model_from_numpy(f, dtype=torch.float64, device="cpu")
    jm = dataclasses.replace(ref.scenario_model, **{
        k: jnp.asarray(f[k]) for k in SCENARIO_FIELDS})
    return pm, jm


def test_repeated_rv_row_scatter_adds_every_position():
    port, ref = _pair("farmer")
    pm, jm = _repeated_rows(port, ref)
    rows = pm.rv_row.numpy()
    assert len(np.unique(rows)) < len(rows)
    rng = np.random.default_rng(7)
    deltas = rng.uniform(-0.3, 0.3, size=(6, pm.n_rv)) * np.maximum(
        np.abs(pm.base.numpy()), 1.0)
    out, jout = _both(port, ref, deltas, np.full(6, 1 / 6), 1e-7, 60_000,
                      port_model=pm, ref_model=jm)
    assert bool(out[2]["ef_converged"])
    _assert_same(out, jout)


def test_warm_start_matches_jax():
    """A solve cut off after 400 iterations, then continued from its
    outputs (x, Y, duals, stage-1 duals, primal weight) in both packages."""
    port, ref = _pair("transship")
    deltas = _deltas(port, 8, seed=4)
    probs = np.full(8, 1 / 8)
    first, jfirst = _both(port, ref, deltas, probs, 1e-7, 400)
    assert not bool(first[2]["ef_converged"])
    _assert_same(first, jfirst)

    def warm(o):
        return dict(x0=o[0], Y0=o[4], U0=o[3], u00=o[5],
                    omega0=o[2]["ef_omega"])
    out, jout = _both(port, ref, deltas, probs, 1e-7, 40_000,
                      warm=(warm(first), warm(jfirst)))
    assert float(out[2]["ef_err0"]) <= float(first[2]["ef_err"]) * (1 + 1e-9)
    assert bool(out[2]["ef_converged"])
    _assert_same(out, jout)


def test_batched_solve_equals_single_solves():
    """R = 3 extensive forms in one call against 3 single calls: each
    replication stops at its own round and keeps its carry after."""
    port, _ = _pair("transship")
    D = np.stack([_deltas(port, 8, seed=s) for s in (3, 4, 5)])
    probs = torch.full((8,), 1 / 8, dtype=torch.float64)
    cfg = PDHGConfig(tol=1e-7, max_iters=40_000)
    xb, objb, stb, *rest = solve_extensive_form(
        port.arrays, port.scenario_model, torch.as_tensor(D), probs, cfg,
        return_duals=True)
    iters = stb["ef_iters"].numpy()
    assert len(set(iters.tolist())) > 1, iters   # they stop apart
    for r in range(3):
        x, obj, st, *single = solve_extensive_form(
            port.arrays, port.scenario_model, torch.as_tensor(D[r]), probs,
            cfg, return_duals=True)
        assert int(st["ef_iters"]) == int(iters[r])
        assert float(obj) == pytest.approx(float(objb[r]), rel=1e-12)
        for a, b in zip([x, *single], [xb, *rest]):
            np.testing.assert_allclose(a.numpy(), b[r].numpy(), rtol=0,
                                       atol=1e-9 * (1 + float(
                                           a.abs().max()) if a.numel()
                                                    else 1.0))


def test_crash_x0_feasible_start():
    """crash_x0 on transship: a converged sampled EF, x finite and inside
    its bounds (tests/test_crash.py:40-52)."""
    port, _ = _pair("transship")
    x, obj, stats = crash_x0(port, n_scenarios=8, seed=1)
    assert bool(stats["ef_converged"]), stats
    x = x.numpy()
    assert np.all(np.isfinite(x)) and np.isfinite(float(obj))
    assert np.all(x >= port.arrays.lb1.numpy() - 1e-6)
    assert np.all(x <= port.arrays.ub1.numpy() + 1e-6)


def test_cli_ef_lands(capsys):
    """python -m sqlp_tpu_torch ef lands on the CPU: a converged sampled EF
    near the lands optimum."""
    assert main(["ef", "lands", "--device", "cpu", "--scenarios", "100"]) == 0
    out = capsys.readouterr()
    assert "converged=True" in out.err, out.err
    m = re.search(r"objective=(\S+)", out.out)
    assert m and abs(float(m.group(1)) - LANDS_OPT) < 12.0, out.out


def test_cli_solve_from_crash_start(capsys):
    """solve --x0 crash: SD starts from the sampled EF's x and ends near
    the lands optimum."""
    assert main(["solve", "lands", "--device", "cpu", "--x0", "crash",
                 "--iters", "30", "--eval-samples", "256",
                 "--log-every", "0"]) == 0
    out = capsys.readouterr()
    assert "crash x0 from 10-scenario EF" in out.err, out.err
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", out.out)
    assert m, out.out
    assert all(abs(float(v) - LANDS_OPT) < 12.0 for v in m.groups())
