"""Upper-bound panels: a closed loop of Monte-Carlo panels of recourse LPs
through the driver's escalation ladder, as ``SDSolver.evaluate_ci``
drives them.

The traffic is a pool of ``pool_panels`` panels of ``panel`` scenarios
each (``sampling``: a method of :class:`sdbench.sampler.Sampler`), drawn
from the fixed ``pool_seed``, the same pool for every ``--seed``: a panel's
work follows its hardest LPs (the compaction ladder's tail; ssn's
panels take 100 to 400 rounds), so panels drawn afresh for each seed,
or a window that ends inside a pass over the pool, would make the seed
change the work. The seed orders the pool, a new order each pass, and
picks the rows the check reads; the window is whole passes.

Set-up loads the instance (``load_instance``), builds the solver
(``SDSolver``: the host's recourse bound, ``prepare_lp``), reads the
evaluation point, draws the pool, and solves one warm-up panel (the
pool stream's next draw) at the cell's shape. The window then takes panel
after panel, forms its right-hand sides at x (the driver's
``_scenario_rhs``) and certifies every value
(``SDSolver._recourse_objs``: the f32 solve, the f32 re-solve, the f64
re-solve, the host's exact solve), and closes at the end of the first
pass over the pool that ends past ``--seconds``. Each panel's seconds go
to standard error.

The check, after the window: ``check_rows`` rows drawn from the seed
across the window's panels, whichever rung or step of the ladder solved
them. For each, the right-hand side the program formed and the value it
returned are held against the reference's (``sdbench.reference``:
float64 right-hand sides, HiGHS), and the certificate of the value,
the (y, pi) and the KKT error that the solve which certified the row
returned (the panel's solve with its compaction rungs, a re-solve or the
float64 re-solve, all caught in the window as they come), is worked out
again in float64, by the numbers of :func:`checks`.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from sdbench import harness, reference, smps
from sdbench.sampler import Sampler
from sdbench.trace import traced


def _point(lp: smps.TwoStage, rule: str) -> np.ndarray:
    if rule == "zero":
        return np.zeros(lp.c.shape[0])
    if rule == "first_stage_nearest_zero":
        return reference.first_stage_point(lp)
    raise ValueError(f"unknown evaluation point {rule!r}")


def _solver_config(cfg: dict):
    from sqlp_tpu_torch.config import PDHGConfig, SDConfig
    kw = dict(cfg["solver"])
    pdhg = PDHGConfig(**kw.pop("pdhg"))
    return SDConfig(pdhg=pdhg, dtype=cfg["dtype"], **kw)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> harness.Outcome:
    import torch

    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd import driver
    from sqlp_tpu_torch.sd.algorithm import _scenario_rhs

    P = cell.params
    B = int(P["panel"])
    data = harness.instance_dir(cell.config)
    lp = smps.read_two_stage(data)
    disc = smps.read_discrete(data, lp)
    x = _point(lp, P["x"])

    config = _solver_config(cell.config)
    dt = config.jdtype
    dev = torch.device(device)
    inst = load_instance(data, dtype=dt, device=dev)
    # the program's random variables in its own order, by row name
    names = [inst.sp2.row_names[i]
             for i in inst.scenario_model.rv_row.cpu().tolist()]
    where = {r: k for k, r in enumerate(disc.rows)}
    perm = torch.as_tensor([where[r] for r in names], device=dev)
    solver = driver.SDSolver(inst, config, x0=x, seed=0)
    x_t = torch.as_tensor(x, dtype=dt, device=dev)
    scale = solver.obj_scale
    sampler = Sampler(disc, dev)

    def _rhs(deltas):
        return _scenario_rhs(solver.arrays, inst.scenario_model,
                             deltas[:, perm].to(dt), x_t)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the pool, then one warm-up panel from the same stream
    draws = torch.Generator(device=dev)
    draws.manual_seed(int(P["pool_seed"]))
    sample = getattr(sampler, P["sampling"])
    pool = [sample(draws, B) for _ in range(int(P["pool_panels"]))]
    solver._recourse_objs(_rhs(sample(draws, B)))
    sync()

    pick = np.random.default_rng([seed, 1])
    order = []
    n_check = int(P["check_rows"])
    kept = []          # per panel: rows, deltas, H, values, certificates
    rounds, per_panel = [], []
    fallback0 = solver.host_fallback_count
    solve_batch = driver.solve_batch
    cur = {}           # the panel in flight: its H and checked rows

    def counted(lp_, H, *a, **k):
        out = solve_batch(lp_, H, *a, **k)
        rounds.append(int(out[3]["pdhg_rounds"]))
        cur["certs"].append(_certificates(H, out, cur))
        return out

    launches0 = _launches()
    driver.solve_batch = counted
    try:
        with traced(trace) as tr:
            t0 = time.time()
            setup_s = t0 - t_start
            while True:
                tp = time.time()
                n_rounds0 = len(rounds)
                if not order:
                    order = list(pick.permutation(len(pool)))
                deltas = pool[order.pop()]
                # rows to check, drawn from the seed; kept on the device
                rows = np.sort(pick.choice(B, size=min(n_check, B),
                                           replace=False))
                ri = torch.as_tensor(rows, device=dev)
                cur.update(ri=ri, H=None, certs=[])
                H = _rhs(deltas)
                cur.update(H=H, Hc=H[ri])
                vals = solver._recourse_objs(H) * scale
                kept.append((rows, deltas[ri], cur["Hc"], vals[rows],
                             cur["certs"]))
                per_panel.append((time.time() - tp,
                                  sum(rounds[n_rounds0:])))
                if not order and time.time() - t0 >= seconds:
                    break
            sync()
            window_s = time.time() - t0
    finally:
        driver.solve_batch = solve_batch
    launches = _launches_since(launches0)
    n_panels = len(kept)
    lps = n_panels * B
    for i, (s, r) in enumerate(per_panel):
        print(f"panel {i}: {s:.4f} s, {r} PDHG rounds", file=sys.stderr)
    dinfo = harness.device_info(device)
    fallback = solver.host_fallback_count - fallback0

    obs = {"kind": "mc_ub", "lps": lps, "panels": n_panels,
           "host_fallback": fallback, "pdhg_rounds": sum(rounds),
           "launches": launches, "m": int(inst.m2), "n": int(inst.n2),
           "window_s": window_s}
    breakdown = None
    if tr.trace is not None:
        tr.trace.window_s = window_s
        obs["trace"] = tr.trace
        dinfo["busy_s"] = tr.trace.busy_s()
        dinfo["window_s"] = window_s
        breakdown = tr.trace.breakdown()

    # the program's state is freed before the reference runs
    del solver, inst
    checks = _check(lp, disc, x, kept, P, n_check, pick)
    return harness.Outcome(
        attempted=lps, failed=0, checks=checks,
        end_to_end={"lp_solves_per_s": lps / window_s, "setup_s": setup_s},
        obs=obs, device=dinfo, breakdown=breakdown)


def _certificates(H, out, cur):
    """What one solve of the ladder says of the panel's checked rows:
    (rows found in this solve [k], their y [k, n2], pi [k, m2], KKT error
    [k], certified [k]), on the device. The panel's own solve holds every
    row at its place; a re-solve holds some of them, found by their
    right-hand side (the ladder hands its rows on unchanged)."""
    import torch
    _, Y, Pi, st = out
    err, valid = st["pdhg_err"], st["pdhg_valid"]
    if H is cur["H"]:
        j = cur["ri"]
        found = torch.ones(j.shape[0], dtype=torch.bool, device=j.device)
    else:
        same = (H[:, None, :] == cur["Hc"][None, :, :].to(H.dtype)).all(-1)
        found = same.any(0)
        j = same.int().argmax(0)
    return found, Y[j], Pi[j], err[j], valid[j] & found


def _check(lp, disc, x, kept, P, n_check, pick):
    """The reference over ``n_check`` of the kept rows, drawn from the
    seed across the panels."""
    cand = [(i, j) for i, k in enumerate(kept) for j in range(len(k[0]))]
    sel = pick.choice(len(cand), size=min(n_check, len(cand)), replace=False)
    D, H, v, Y, Pi, err, cert = [], [], [], [], [], [], []
    for s in sel:
        i, j = cand[s]
        _, deltas, Hc, vals, certs = kept[i]
        D.append(deltas[j].cpu().numpy())
        H.append(Hc[j].double().cpu().numpy())
        v.append(vals[j])
        # the last solve of the ladder that certified the row
        last = [c for c in certs if bool(c[4][j])]
        if last:
            _, Yc, Pc, ec, _ = last[-1]
            Y.append(Yc[j].double().cpu().numpy())
            Pi.append(Pc[j].double().cpu().numpy())
            err.append(float(ec[j]))
        cert.append(bool(last))
    D, H, v = np.stack(D), np.stack(H), np.array(v, np.float64)
    cert = np.array(cert)
    H_ref = reference.scenario_rhs(lp, disc, D, x)
    v_ref = reference.recourse_values(lp, H_ref)
    n2, m2 = lp.W.shape[1], lp.W.shape[0]
    Y = np.stack(Y) if Y else np.zeros((0, n2))
    Pi = np.stack(Pi) if Pi else np.zeros((0, m2))
    return checks(lp, H, v, H_ref, v_ref, cert, Y, Pi, np.array(err),
                  P["limits"])


def checks(lp, H, v, H_ref, v_ref, cert, Y, Pi, err, limits):
    """The numbers compared, each with its limit; a cell compares those
    its ``limits`` name. Over the checked rows, or over those of them
    that a device solve certified (``cert``: its y, pi [in the units of
    the normalised objective] and stated KKT error ``err``), or over the
    rest, which the
    ladder solved on the host; a number over no rows reads 0:

    - ``rhs_gap``: the widest gap of a right-hand side, max over rows of
      max |h - h_ref| / (1 + max |h_ref|);
    - ``value_gap_p75``: the upper quartile over rows of
      |v - v_ref| / (1 + |v| + |v_ref|). Not the widest: the PDHG
      certifies each value to a relative KKT error of 1e-4, and the few
      rows it stops just under that read gaps of that size in every
      precision; the quartile reads the arithmetic of the rest;
    - ``cert_gap``: certified rows, the widest |e - err| between the KKT
      error e of the row's (v, y, pi) that the reference works out in
      float64, the value v taken for the primal objective, and the error
      the program stated: a certificate computed in a lower precision, a
      y that does not solve the row, or a value that is not its y's
      objective reads as a gap;
    - ``cert_err_max``: certified rows, the largest stated error (the
      guarantee: valid_tol);
    - ``host_value_gap``: the other rows, the widest
      |v - v_ref| / (1 + |v| + |v_ref|): the host solves them exactly."""
    rhs_gap = np.abs(H - H_ref).max(1) / (1.0 + np.abs(H_ref).max(1))
    val_gap = np.abs(v - v_ref) / (1.0 + np.abs(v) + np.abs(v_ref))

    def widest(a):
        return float(np.max(a)) if len(a) else 0.0
    e = reference.kkt_errors(lp, H_ref[cert], Y, Pi, v[cert]) \
        if cert.any() else np.zeros(0)
    got = {"rhs_gap": float(rhs_gap.max()),
           "value_gap_p75": float(np.percentile(val_gap, 75)),
           "cert_gap": widest(np.abs(e - err)),
           "cert_err_max": widest(err),
           "host_value_gap": widest(val_gap[~cert])}
    return [harness.Check(name, got[name], limit)
            for name, limit in limits.items()]


def _launches() -> dict:
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel
    return dict(pdhg_kernel.launches_by_shape)


def _launches_since(before: dict) -> dict:
    """PDHG kernel launches since ``before``, by (counter, rows,
    itemsize)."""
    now = _launches()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0) > 0}
