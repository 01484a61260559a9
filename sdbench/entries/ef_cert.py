"""The certification EF's first pass: R extensive forms of S fresh
Latin-hypercube scenarios each, solved in float32 by the program's
structured PDHG (``models/crash.py:solve_extensive_form``) as
``sd/lower_bound.py:saa_ef_bound`` calls it (tol 1e-5, every replication
in one batched call).

Set-up loads the instance, draws the [R, S, Rv] deltas from the seed
(``sampling``, a method of :class:`sdbench.sampler.Sampler`: one
hypercube a replication) and runs one one-round call at the cell's
shapes. The window then calls the solve: first ``check_rounds`` rounds
from zero, then ``rounds_per_call`` rounds at a time, each call from the
iterate, duals and primal weight the last one returned; it closes at the
first call boundary past ``--seconds``, after two calls at least. Each
call's seconds and steps go to standard error. A call that leaves every
replication converged makes the next one start from zero again.

The check, after the window, by the plain reference
(``sdbench.ef_reference``, float64), in two parts:

- The window's first call, followed: the reference runs the same rounds
  from zero on the benchmark's deltas, and its decision x and objective
  are held against the program's (``start_x_gap``: max over
  replications of max |x - x_ref| / (1 + max |x_ref|); ``start_obj_gap``:
  of |f - f_ref| / (1 + |f_ref|)). Only a short call is followed: each
  round ends in decisions (the average or the last iterate, a restart,
  the best so far) taken on residuals that float32 and float64 compute a
  little apart, and on some seeds one of them falls on a near tie within
  65 rounds; from there the two trajectories part ways and read gaps as
  wide as TF32's. Within ``check_rounds`` rounds from zero the residuals
  are still large and no seed parted.
- The window's last call, judged by what it returned, whatever path the
  rounds took: the reference works out in float64 the KKT error e of the
  returned iterate (x, Y, U, u0) in the program's own measure, the
  returned objective taken for the primal one (an objective that is not
  the iterate's reads as a gap). ``last_err_gap``: max over replications
  of |e - e_stated|, the error the program stated beside it (its TF32
  path states its error some 1e-4 off); ``last_progress``: the geometric
  mean, over the replications still
  short of ``tol``, of e / e_before, e_before the error of the iterate
  the chain of calls (the calls since the last start from zero) began
  from: its first call's return, or zero when the last call is its
  first. A chain whose warm-started calls hand back their state reads 1.
"""

from __future__ import annotations

import sys
import time

from sdbench import harness, smps
from sdbench.sampler import Sampler
from sdbench.trace import traced


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> harness.Outcome:
    import torch

    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.models.crash import solve_extensive_form
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    configure_torch()
    P = cell.params
    R, S = int(P["replications"]), int(P["scenarios"])
    per_call = int(P["rounds_per_call"])
    check_rounds = int(P["check_rounds"])
    data = harness.instance_dir(cell.config)
    lp = smps.read_two_stage(data)
    disc = smps.read_discrete(data, lp)
    dt = getattr(torch, cell.config["dtype"])
    dev = torch.device(device)
    inst = load_instance(data, dtype=dt, device=dev)
    names = [inst.sp2.row_names[i]
             for i in inst.scenario_model.rv_row.cpu().tolist()]
    where = {r: k for k, r in enumerate(disc.rows)}
    perm = torch.as_tensor([where[r] for r in names], device=dev)
    sampler = Sampler(disc, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    sample = getattr(sampler, P["sampling"])

    def draw():
        return torch.stack([sample(gen, S) for _ in range(R)])

    deltas = draw()
    probs = torch.full((S,), 1.0 / S, dtype=dt, device=dev)
    ef = cell.config["ef"]
    def cfg(rounds):
        return PDHGConfig(tol=float(ef["tol"]), max_iters=80 * rounds,
                          restart_every=80)

    def call(D, start, rounds):
        kw = {}
        if start is not None:
            kw = dict(x0=start[0], Y0=start[1], U0=start[2], u00=start[3],
                      omega0=start[4])
        x, obj, st, U, Y, u0 = solve_extensive_form(
            inst.arrays, inst.scenario_model, D[..., perm].to(dt), probs,
            cfg(rounds), return_duals=True, **kw)
        return (x, Y, U, u0, st["ef_omega"]), obj, st

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    call(deltas, None, 1)
    sync()

    steps = 0                    # replication-steps
    calls = 0
    first = None                 # (deltas, x, objective, rounds)
    chain = None                 # [deltas, its first call's return, calls]
    start = None
    with traced(trace) as tr:
        t0 = time.time()
        setup_s = t0 - t_start
        while True:
            tc = time.time()
            state, obj, st = call(deltas, start,
                                  check_rounds if first is None else per_call)
            iters = st["ef_iters"].cpu()
            steps += int(iters.sum())
            if first is None:
                first = (deltas, state[0], obj, int(iters.max()) // 80)
            if start is None:
                chain = [deltas, state, 0]
            chain[2] += 1
            print(f"call {calls}: {time.time() - tc:.4f} s, "
                  f"{int(iters.sum())} replication-steps", file=sys.stderr)
            calls += 1
            if bool(st["ef_converged"].all()):
                deltas, start = draw(), None
            else:
                start = state
            # the first call and at least one warm-started call
            if calls >= 2 and time.time() - t0 >= seconds:
                break
        sync()
        window_s = time.time() - t0
    dinfo = harness.device_info(device)
    obs = {"kind": "ef", "rep_steps": steps, "S": S, "window_s": window_s,
           "dtype": cell.config["dtype"],
           "dims": (int(inst.m1), int(inst.n1), int(inst.m2), int(inst.n2))}
    breakdown = None
    if tr.trace is not None:
        tr.trace.window_s = window_s
        obs["trace"] = tr.trace
        dinfo["busy_s"] = tr.trace.busy_s()
        dinfo["window_s"] = window_s
        breakdown = tr.trace.breakdown()

    D, x0, obj0, rounds = first
    last = (state, obj, st["ef_err"])
    # the program's state is freed before the reference runs
    del first, inst, start, deltas
    checks = _check(lp, disc, D, x0, obj0, rounds, chain, last,
                    float(ef["tol"]), P["limits"])
    return harness.Outcome(
        attempted=R * calls, failed=0, checks=checks,
        end_to_end={"ef_scenario_steps_per_s": steps * S / window_s,
                    "setup_s": setup_s},
        obs=obs, device=dinfo, breakdown=breakdown)


def _check(lp, disc, D, x0, obj0, rounds, chain, last, tol, limits):
    import torch

    from sdbench.ef_reference import EF
    f8 = torch.float64
    ref = EF(lp, disc, D.to(f8), f8)
    x_r, obj_r, _, _ = ref.solve(rounds, tol=tol)
    out = gaps("start", x0.to(x_r), obj0.to(obj_r), x_r, obj_r, limits)
    D_c, begun, n_calls = chain
    if D_c is not D:
        del ref
        ref = EF(lp, disc, D_c.to(f8), f8)
    state, obj, err = last
    e = ref.error(state[:4], objective=obj)
    e_before = ref.error(begun[:4] if n_calls > 1 else None)
    live = e_before > tol
    ratio = (e / e_before)[live]
    # a replication can keep a lucky early best for a while: the
    # geometric mean reads the chain as a whole
    progress = float(ratio.log().mean().exp()) if len(ratio) else 0.0
    return out + [
        harness.Check("last_err_gap",
                      float((e - err.to(e)).abs().max()),
                      limits["last_err_gap"]),
        harness.Check("last_progress", progress, limits["last_progress"])]


def gaps(tag, x, obj, x_r, obj_r, limits):
    xg = ((x - x_r).abs().amax(1) / (1.0 + x_r.abs().amax(1))).max()
    og = ((obj - obj_r).abs() / (1.0 + obj_r.abs())).max()
    return [harness.Check(f"{tag}_x_gap", float(xg),
                          limits[f"{tag}_x_gap"]),
            harness.Check(f"{tag}_obj_gap", float(og),
                          limits[f"{tag}_obj_gap"])]
