"""The reference bench's sections on the port: recourse-LP throughput and
time to an SD gap, ssn, storm and lands.

Port of record: the root ``bench.py`` (``_bench_throughput`` :148-209,
``_bench_sd_gap`` :212-247, ``_bench_certified`` :250-358,
``_bench_target_gap`` :361-381, ``child`` :384-482, here :func:`run`).

    python -m sqlp_tpu_torch bench                      # on the card
    python -m sqlp_tpu_torch bench --skip-sd-gap        # throughput only
    python -m sqlp_tpu_torch bench --cpu-baseline-only  # CPU, CPU depths

Headline metric: ssn recourse LPs solved per second in one batched PDHG
call at B = 4096 (tol 1e-4), against serial exact HiGHS solves of the
same LPs one at a time on this host (the reference's architecture: hand
each scenario's LP to an exact solver). Then the reference's SD
workloads: ssn for 3000 iterations and storm for 1500, each with the
trailing lower-bound estimate and an 8192-sample stratified Monte-Carlo
bound; the certified gaps of storm (model route) and ssn (EF dual
certificates over antithetic fresh streams); lands' time to a 1 %
certified gap. ``DEPTHS`` holds each section's arguments on the card and
on the CPU.

The bench runs in its own process on the device it was asked for: the
card, or the CPU under ``--cpu-baseline-only``; without a card and
without that flag it exits 2 before any section runs. It has no backend
probe, retry, child process or fall back to the CPU. As each section
ends it prints ``{"section": name, ...}`` on a flushed line, so a run cut
short keeps the sections it finished; the last line is the reference's
object. A section that raises is recorded as ``{"error": "Type: msg"}``,
the later sections still run, and the process exits 1.

Wall clocks are the host's, read after ``torch.cuda.synchronize()`` on
the card; every number printed is a Python number taken off the device.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback

SECTIONS = ("throughput", "ssn_time_to_gap", "storm_time_to_gap",
            "storm_certified", "ssn_certified", "lands_target_gap")

# each section's arguments on the card ("cuda": the reference's on-chip
# depths) and on the CPU (its reduced CPU depths, labelled by "note")
DEPTHS = {
    "cuda": {
        "throughput": {"B": 4096},
        "ssn_time_to_gap": {"n_iters": 3000},
        "storm_time_to_gap": {"n_iters": 1500},
        "storm_certified": {"n_reps": 4, "n_iters": 1500, "method": "model",
                            "ub_samples": 65536, "ub_half_width": 3000.0},
        "ssn_certified": {"n_reps": 16, "n_iters": 3000,
                          "fresh_scenarios": 3000, "ub_samples": 786432,
                          "ub_half_width": 0.045, "antithetic_reps": True},
        "lands_target_gap": {"max_iters": 400, "certify_every": 200,
                             "min_ub_samples": 8192,
                             "max_ub_samples": 65536,
                             "fresh_scenarios": 1024},
    },
    "cpu": {
        "throughput": {"B": 512},
        "ssn_time_to_gap": {"n_iters": 200},
        "storm_time_to_gap": {"n_iters": 60},
        "storm_certified": {"n_reps": 2, "n_iters": 60, "method": "model",
                            "ub_samples": 4096, "ub_half_width": 0.0},
        "ssn_certified": {"n_reps": 2, "n_iters": 200,
                          "fresh_scenarios": 256, "ub_samples": 4096,
                          "ub_half_width": 0.0, "antithetic_reps": False},
        "lands_target_gap": {"max_iters": 200, "certify_every": 100,
                             "min_ub_samples": 2048, "max_ub_samples": 2048,
                             "fresh_scenarios": 256},
        "note": "CPU run (--cpu-baseline-only): reduced batch B=512, "
                "sd_iters=200",
    },
}

# the instance each SD section runs on
_INSTANCE = {"throughput": "ssn", "ssn_time_to_gap": "ssn",
             "storm_time_to_gap": "storm", "storm_certified": "storm",
             "ssn_certified": "ssn"}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(v):
    """A numpy array of a tensor on any device, or of an array-like."""
    import numpy as np
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _plain(v):
    """JSON-ready: numpy and 0-d torch scalars as Python numbers."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    return v


def _config(instance: str):
    """The reference bench's configuration of an instance: ssn at the
    flagship driver's adaptive prox schedule (rho0 1e-3), storm at the
    defaults; both at PDHG tol 1e-4 and 80,000 iterations."""
    from sqlp_tpu_torch.config import PDHGConfig, SDConfig
    kw = {"quad_schedule": "adaptive", "quad_scalar_init": 1e-3} \
        if instance == "ssn" else {}
    return SDConfig(pdhg=PDHGConfig(tol=1e-4, max_iters=80_000), **kw)


def _bench_throughput(inst, config, B: int) -> dict:
    """Batched-PDHG LP throughput against serial exact host solves."""
    import numpy as np
    import torch

    from sqlp_tpu_torch.models.routines import solve_lp_host
    from sqlp_tpu_torch.models.scenario import sample_deltas
    from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch
    from sqlp_tpu_torch.sd.algorithm import _scenario_rhs

    dev = inst.device
    a = inst.arrays
    x = torch.zeros(inst.n1, dtype=a.c.dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    deltas = sample_deltas(gen, inst.scenario_model, B)
    H = _scenario_rhs(a, inst.scenario_model, deltas, x)
    prep = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)

    # warm-up: plans and occupancy queries are made and cached here
    obj, _, _, _ = solve_batch(prep, H, config.pdhg)
    _host(obj)

    best = math.inf
    for _ in range(3):
        _sync(dev)
        t0 = time.time()
        obj, _, _, _ = solve_batch(prep, H, config.pdhg)
        _sync(dev)
        obj_h = _host(obj)
        best = min(best, time.time() - t0)
    throughput = B / best

    # honesty check: spot-compare against the exact host solver
    Hn = _host(H).astype(np.float64)
    q64, W64 = _host(a.q).astype(np.float64), _host(a.W).astype(np.float64)
    s2 = _host(a.senses2)
    lb64 = _host(a.lb2).astype(np.float64)
    ub64 = _host(a.ub2).astype(np.float64)
    rel_errs = []
    for b in range(0, B, max(B // 4, 1)):
        ref, _, _ = solve_lp_host(q64, W64, Hn[b], s2, lb64, ub64)
        rel_errs.append(abs(float(obj_h[b]) - ref) / (1.0 + abs(ref)))
    if not max(rel_errs) < 1e-3:
        raise AssertionError(f"objective mismatch vs HiGHS: {rel_errs}")

    # baseline: serial exact solves, one scenario at a time, on this
    # host; the median of 5 runs of 16, the spread beside it
    n_base = 16
    base_runs = []
    for _ in range(5):
        t0 = time.time()
        for b in range(n_base):
            solve_lp_host(q64, W64, Hn[b], s2, lb64, ub64)
        base_runs.append(n_base / (time.time() - t0))
    base_throughput = float(np.median(base_runs))

    return {"throughput": throughput, "baseline": base_throughput,
            "baseline_runs": [round(r, 2) for r in sorted(base_runs)],
            "batch": B, "max_rel_err_vs_highs": max(rel_errs)}


def _bench_sd_gap(inst, config, n_iters: int) -> dict:
    """The reference's SD driver workload: wall clock of n_iters SD
    iterations, then the final lower-bound estimate and an 8192-sample
    stratified Monte-Carlo bound."""
    import numpy as np

    from sqlp_tpu_torch.sd.driver import SDSolver

    # a discarded warm-up run over a full driver chunk (256) makes the
    # timed run's plans and cached occupancy queries
    warm = SDSolver(inst, config, seed=1)
    warm.run(min(n_iters, 256))
    del warm

    solver = SDSolver(inst, config, seed=0)
    _sync(inst.device)
    t0 = time.time()
    solver.run(n_iters, log_every=1)
    _sync(inst.device)
    wallclock = time.time() - t0
    lb = solver.lower_estimate
    # the candidate estimate is a noisy series (every cut moves it); the
    # trailing mean is the stable read
    lb_tail = [float(h["cand_est"]) for h in solver.history[-100:]]
    ub, hw, n = solver.evaluate_ci(min_samples=8192, max_samples=8192,
                                   seed=7, sampling="stratified")
    gap = (ub - lb) / max(abs(ub), 1e-9)
    return {"sd_iters": n_iters, "sd_wallclock_s": round(wallclock, 2),
            "sd_iters_per_sec": round(n_iters / wallclock, 2),
            "gap_kind": "proxy (lb_est is the cut-model estimate, not a "
                        "valid bound; the certified gap is ssn_certified)",
            "lb_est": round(lb, 4),
            "lb_est_mean_last100": round(float(np.mean(lb_tail)), 4),
            "mc_ub": round(ub, 4),
            "mc_ub_half_width": round(hw, 4), "rel_gap": round(gap, 5)}


def _bench_certified(inst, config, n_reps: int, n_iters: int,
                     fresh_scenarios: int = 0, ub_samples: int = 65536,
                     ub_half_width: float = 0.0, method: str = "ef",
                     antithetic_reps: bool = False) -> dict:
    """The certified optimality gap: R lockstep SD replications, one
    deterministic bound per replication (``method``: "ef" dual
    certificates over ``fresh_scenarios`` Latin-hypercube scenarios, or
    the "model" route), their Student-t 95 % lower bound, the best of the
    compromise decision and the EF argmins on a shared panel, and the
    winner's stratified bound on an independent one (resampled until its
    half-width is ``ub_half_width``, up to ``ub_samples``).
    cert_gap = ((ub + hw) - (lb_mean - lb_hw)) / |ub + hw|."""
    import numpy as np

    from sqlp_tpu_torch.sd.compromise import compromise_decision
    from sqlp_tpu_torch.sd.driver import SDReplications

    dev = inst.device
    t0 = time.time()
    s = SDReplications(inst, config, n_replications=n_reps, seed=0)
    s.run(n_iters)
    _sync(dev)
    sd_wall = time.time() - t0

    t0 = time.time()
    kw = {"fresh_scenarios": fresh_scenarios,
          "antithetic_reps": antithetic_reps} if method == "ef" else {}
    cert = s.certified_lower_bound(method=method, **kw)
    _sync(dev)
    cert_wall = time.time() - t0

    t0 = time.time()
    x_comp, _ = compromise_decision(inst, s.states, s.especs, rho=1.0,
                                    qp_config=config.qp,
                                    obj_scale=s.obj_scale)
    # candidates: the compromise and, on the EF route, the certification
    # solves' argmins; picked on a shared panel, the winner re-evaluated
    # on an independent one so that its bound stays unbiased
    candidates = {"compromise": x_comp}
    if "x_ef_per_rep" in cert:
        x_ef = _host(cert["x_ef_per_rep"]).astype(np.float64)
        candidates["ef_avg"] = x_ef.mean(axis=0)
        # even indices: under antithetic pairing the odd replications are
        # the complements of the even ones' streams
        for r in range(0, min(6, x_ef.shape[0]), 2):
            candidates[f"ef_{r}"] = x_ef[r]
    if len(candidates) > 1:
        sel = s.select_decision(candidates,
                                n_samples=min(16384, ub_samples), seed=11)
        x_best, chosen = sel["x"], sel["name"]
    else:
        x_best, chosen, sel = x_comp, "compromise", None
    ub_c, hw_c, n_ub = s.evaluate_ci(
        x=x_best, min_samples=min(32768, ub_samples),
        max_samples=ub_samples, target_half_width=ub_half_width, seed=7,
        batch=8192, sampling="stratified")
    _sync(dev)
    ub_wall = time.time() - t0
    lb_per_rep = _host(cert["lb_per_rep"])
    lo = float(cert["lb_mean"]) - float(cert["lb_half_width"])
    hi = ub_c + hw_c
    return {"n_replications": n_reps, "sd_iters": n_iters,
            "cert_method": method,
            "decision": chosen,
            "decision_selection": None if sel is None else
            {k: [round(float(v[0]), 4), round(float(v[1]), 4)]
             for k, v in sel["table"].items()},
            "n_cert_scenarios": int(cert.get("n_scenarios", 0)),
            "sd_wall_s": round(sd_wall, 2),
            "cert_wall_s": round(cert_wall, 2),
            "ub_wall_s": round(ub_wall, 2),
            "total_wall_s": round(sd_wall + cert_wall + ub_wall, 2),
            "lb_cert": round(float(cert["lb_cert"]), 4),
            "lb_mean": round(float(cert["lb_mean"]), 4),
            "lb_half_width": round(float(cert["lb_half_width"]), 4),
            "lb_per_rep_min": round(float(lb_per_rep.min()), 4),
            "lb_per_rep_max": round(float(lb_per_rep.max()), 4),
            "ef_err_max": float(_host(cert["ef_err_per_rep"]).max())
            if "ef_err_per_rep" in cert else None,
            "dual_infeas_max": float(_host(cert["dual_infeas_per_rep"]).max())
            if "dual_infeas_per_rep" in cert else None,
            "confidence": 0.95,
            # the selected decision's independent-panel estimate (the
            # 'decision' field names the winner; the key is the
            # reference's)
            "decision_mc_ub": round(ub_c, 4),
            "decision_mc_ub_half_width": round(hw_c, 4),
            "mc_ub_samples": int(n_ub),
            "host_fallback_count": int(getattr(s, "host_fallback_count",
                                               0)),
            "cert_gap": round((hi - lo) / max(abs(hi), 1e-9), 5)}


def _bench_target_gap(device, max_iters: int, certify_every: int,
                      min_ub_samples: int, max_ub_samples: int,
                      fresh_scenarios: int) -> dict:
    """Certified-gap stopping on lands: 4 replications in rounds,
    certified every ``certify_every`` iterations (the free cut-model route
    first, the level-bundle polish when it misses), stopped at a 1 %
    certified gap (``SDReplications.solve_to_certified_gap``)."""
    from sqlp_tpu_torch.config import SDConfig, autoscale_capacities
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDReplications

    cfg = autoscale_capacities(SDConfig(), 400)
    inst = load_instance("lands", dtype=cfg.jdtype, device=device)
    s = SDReplications(inst, cfg, n_replications=4, seed=0)
    res = s.solve_to_certified_gap(
        0.01, max_iters=max_iters, certify_every=certify_every,
        method="polish", min_ub_samples=min_ub_samples,
        max_ub_samples=max_ub_samples, fresh_scenarios=fresh_scenarios)
    res.pop("x_compromise")
    res.pop("rounds")
    return res


def run_section(name: str, device, depth: dict, instances=None) -> dict:
    """One section at ``depth[name]``'s arguments (``DEPTHS[...]`` or any
    dict of that form) on ``device``; ``instances`` ({name: (inst,
    config)}) keeps the loaded instances for the next section."""
    from sqlp_tpu_torch.models.instance import load_instance

    kw = depth[name]
    if name == "lands_target_gap":
        return _plain(_bench_target_gap(device, **kw))
    instances = {} if instances is None else instances
    iname = _INSTANCE[name]
    if iname not in instances:
        config = _config(iname)
        instances[iname] = (load_instance(iname, dtype=config.jdtype,
                                          device=device), config)
    fn = {"throughput": _bench_throughput,
          "ssn_time_to_gap": _bench_sd_gap,
          "storm_time_to_gap": _bench_sd_gap,
          "storm_certified": _bench_certified,
          "ssn_certified": _bench_certified}[name]
    return _plain(fn(*instances[iname], **kw))


def _emit(name: str, result: dict) -> None:
    print(json.dumps({"section": name, **result}), flush=True)


def run(device, skip_sd_gap: bool = False) -> int:
    """Every section on ``device`` at ``DEPTHS`` of its type, one flushed
    line each, then the reference's object; 1 when a section failed."""
    backend = "cuda" if device.type == "cuda" else "cpu"
    depth = DEPTHS[backend]
    instances = {}
    results = {}
    names = SECTIONS[:1] if skip_sd_gap else SECTIONS
    for name in names:
        try:
            results[name] = run_section(name, device, depth, instances)
        except Exception as e:  # recorded; the later sections still run
            traceback.print_exc()
            results[name] = {"error": f"{type(e).__name__}: {e}"}
        _emit(name, results[name])

    thr = results.pop("throughput")
    out = {"metric": "ssn_subproblems_per_sec_per_chip"}
    if "error" in thr:
        out.update(unit="LP solves/s", backend=backend, error=thr["error"])
    else:
        out.update({
            "value": round(thr["throughput"], 1),
            "unit": "LP solves/s",
            "vs_baseline": round(thr["throughput"] / thr["baseline"], 2),
            "backend": backend,
            "batch": thr["batch"],
            "serial_baseline_lp_per_sec": round(thr["baseline"], 2),
            "serial_baseline_runs": thr["baseline_runs"],
        })
    if "note" in depth:
        out["note"] = depth["note"]
    out.update(results)
    print(json.dumps(out), flush=True)
    failed = "error" in thr or any("error" in r for r in results.values())
    return 1 if failed else 0


def main(argv=None) -> int:
    import torch

    from sqlp_tpu_torch.cli import _device
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    p = argparse.ArgumentParser(
        prog="sqlp_tpu_torch bench",
        description="the reference bench's sections, one JSON line each")
    p.add_argument("--cpu-baseline-only", action="store_true",
                   help="measure on the CPU at the CPU depths")
    p.add_argument("--skip-sd-gap", action="store_true",
                   help="only the LP-throughput metric")
    args = p.parse_args(argv)
    device = torch.device("cpu") if args.cpu_baseline_only else \
        _device(argparse.Namespace(device="cuda"))
    if device is None:
        return 2
    configure_torch()
    return run(device, skip_sd_gap=args.skip_sd_gap)
