"""Command-line entry point of the PyTorch port.

Port of record: ``sqlp_tpu/cli.py`` (``cmd_solve`` :39-189,
``_solve_replicated`` :192-293 without ``--target-gap``, ``cmd_ef``
:296-318, ``cmd_evaluate`` :321-333, the parser :341-470):

    python -m sqlp_tpu_torch solve ssn --iters 3000 --schedule adaptive --rho 1e-3
    python -m sqlp_tpu_torch solve ssn --replications 8 --certify
    python -m sqlp_tpu_torch ef lands --scenarios 100
    python -m sqlp_tpu_torch evaluate transship --samples 20000

runs on the chosen device (``--device``, default ``cuda``; there is no
silent CPU fallback). ``solve`` runs SD and ends with the Monte-Carlo upper
bound and its confidence half-width; with ``--replications R`` it runs R
replications in lockstep and ends with the compromise decision and its
bound, and with ``--certify`` also with a certified statistical lower
bound, the decision picked among the compromise and the certification's
EF argmins, and the certified optimality gap (:func:`certify_replications`).
``ef`` solves a sampled extensive form, ``evaluate`` estimates the expected
cost of a first-stage decision. Flags of the reference CLI that the port
does not carry yet are accepted by the parser and refused with the ROADMAP
item that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flag -> (the values the port takes, ROADMAP item that brings the rest)
_REFUSED = {
    "target_gap": ((0.0,), "A12b (certified-gap stopping)"),
    "certify_method": (("ef", "model"),
                       "A12b (the level-bundle polish route)"),
    "mesh": ((0,), "A14 (multi-device)"),
    "proposal_sto": ((None,), "A13 (importance sampling proposal)"),
}


def _build_config(args):
    from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig
    return SDConfig(
        dtype=args.dtype,
        quad_schedule=args.schedule,
        quad_scalar_init=args.rho,
        max_scenarios=args.max_scenarios,
        max_dual_vertices=args.max_duals,
        max_cuts=args.max_cuts,
        dual_sig_bits=args.dual_sig_bits,
        scenarios_per_iter=args.batch,
        sampling=args.sampling,
        cut_refresh_every=args.cut_refresh,
        pdhg=PDHGConfig(tol=args.sub_tol, max_iters=args.sub_iters),
        qp=QPConfig(tol=args.master_tol, max_iters=args.master_iters),
    )


def _device(args):
    """The run's torch device, or None after an error message: refused
    flags first, then a CUDA device the host does not have."""
    import torch

    for flag, (taken, item) in _REFUSED.items():
        value = getattr(args, flag, taken[0])
        if value not in taken:
            print(f"error: --{flag.replace('_', '-')} {value} is not ported "
                  f"to sqlp_tpu_torch yet (ROADMAP {item})", file=sys.stderr)
            return None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return None
    return device


def cmd_solve(args) -> int:
    import torch

    from sqlp_tpu_torch.config import autoscale_capacities
    from sqlp_tpu_torch.models.crash import crash_x0
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver
    from sqlp_tpu_torch.sd.state import default_epigraph_spec

    if args.replications > 1 and (args.mesh or args.proposal_sto):
        # the reference's own refusal (sqlp_tpu/cli.py:75-82)
        print("error: --mesh/--shard-duals/--proposal-sto are not "
              "supported with --replications > 1 (replications batch "
              "on a single device program); drop one of the flags",
              file=sys.stderr)
        return 2
    if args.certify and args.replications < 2:
        print("error: --certify needs --replications R > 1 (the bound is a "
              "Student-t interval over R replications)", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2

    config = _build_config(args)
    if not args.no_auto_capacity:
        config = autoscale_capacities(config, args.iters,
                                      n_epi=args.epigraphs)
    inst = load_instance(args.instance, dtype=config.jdtype, device=device)
    print(f"{inst.name}: n1={inst.n1} m1={inst.m1} n2={inst.n2} "
          f"m2={inst.m2} R={inst.n_rv} S={config.max_scenarios} "
          f"D={config.max_dual_vertices} device={device}", file=sys.stderr)
    if args.x0 == "crash":
        x0, ef_obj, _ = crash_x0(inst, n_scenarios=args.crash_scenarios,
                                 seed=args.seed)
        x0 = x0.cpu().numpy().astype(np.float64)
        print(f"crash x0 from {args.crash_scenarios}-scenario EF "
              f"(obj {float(ef_obj):.4f})", file=sys.stderr)
    else:
        x0 = np.zeros(inst.n1)
    E = args.epigraphs
    espec = None
    if args.epi_lb is not None:
        espec = default_epigraph_spec(E, 1.0 / E, args.epi_lb,
                                      dtype=config.jdtype, device=device)
    if args.replications > 1:
        return _solve_replicated(args, config, inst, espec, x0, device)
    solver = SDSolver(inst, config, espec=espec, x0=x0, seed=args.seed,
                      n_epi=E)
    print(f"recourse lower bound: {solver.recourse_lb:.6g}"
          + (" (auto)" if args.epi_lb is None
             else f" (user: {args.epi_lb:g})"), flush=True)

    t0 = time.time()
    period = args.log_every if args.log_every else args.iters
    done = 0
    while done < args.iters:
        n = min(period, args.iters - done)
        last = solver.run(n)
        done += n
        if args.log_every:
            print(f"iter {int(last['it'])}: lb_est={last['cand_est']:.4f} "
                  f"rho={last['rho']:.4g} duals={int(last['n_duals'])} "
                  f"cuts={int(last['n_cuts_live'])}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    ub, ub_hw, ub_n = solver.evaluate_ci(min_samples=args.eval_samples,
                                         max_samples=args.eval_samples,
                                         seed=args.seed + 1,
                                         sampling=args.sampling)
    print(f"done: {done} iters in {elapsed:.1f}s "
          f"({done / max(elapsed, 1e-9):.1f} it/s)", file=sys.stderr)
    print(f"lb_est={solver.lower_estimate:.6f} mc_ub={ub:.6f} "
          f"(95% +- {ub_hw:.4f}, N={ub_n})")
    print(f"x_incumbent={np.round(solver.x_incumbent, 6).tolist()}")
    return 0


def _solve_replicated(args, config, inst, espec, x0, device) -> int:
    """R SD replications in lockstep, then the compromise decision and its
    stratified Monte-Carlo bound (sqlp_tpu/cli.py:192-251), and under
    ``--certify`` the certified gap (:func:`certify_replications`)."""
    import torch

    from sqlp_tpu_torch.sd.compromise import compromise_decision
    from sqlp_tpu_torch.sd.driver import SDReplications

    R = args.replications
    t0 = time.time()
    s = SDReplications(inst, config, n_replications=R, espec=espec, x0=x0,
                       seed=args.seed, n_epi=args.epigraphs)
    s.run(args.iters)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sd_s = time.time() - t0
    print(f"SD: {R} x {args.iters} iters in {sd_s:.1f}s "
          f"({args.iters / max(sd_s, 1e-9):.1f} it/s)", file=sys.stderr)
    for r in range(R):
        ub = s.evaluate(x=s.x_incumbents[r], n_samples=args.eval_samples,
                        seed=args.seed + 10_000)
        print(f"replication {r}: lb_est={s.lower_estimates[r]:.6f} "
              f"mc_ub={ub:.6f}", file=sys.stderr)
    x_comp, info = compromise_decision(
        inst, s.states, s.especs, rho=args.compromise_rho,
        qp_config=config.qp, obj_scale=s.obj_scale)
    ub_comp, ub_hw, _ = s.evaluate_ci(
        x=x_comp, min_samples=args.eval_samples,
        max_samples=args.eval_samples, seed=args.seed + 20_000,
        sampling="stratified")
    ub_bar = s.evaluate(x=info["x_bar"], n_samples=args.eval_samples,
                        seed=args.seed + 20_000)
    print(f"done: {R} x {args.iters} iters in {time.time() - t0:.1f}s "
          f"(compromise ub half-width {ub_hw:.4f})", file=sys.stderr)
    print(f"mc_ub_compromise={ub_comp:.6f} mc_ub_average={ub_bar:.6f}")
    print(f"x_compromise={np.round(x_comp, 6).tolist()}")
    if args.certify:
        out = certify_replications(
            s, x_comp, ub_comp, ub_hw, method=args.certify_method,
            fresh_scenarios=args.certify_scenarios,
            eval_samples=args.eval_samples, seed=args.seed)
        cert = out["cert"]
        if out["decision"] != "compromise":
            table = {k: round(v[0], 4) for k, v in out["selection"].items()}
            print(f"decision={out['decision']} mc_ub={out['ub']:.6f} "
                  f"(selection: {table})")
        print(f"certified in {out['seconds']['certify']:.1f}s over "
              f"{cert.get('n_scenarios', 0)}-scenario streams",
              file=sys.stderr)
        print(f"lb_cert={cert['lb_cert']:.6f} "
              f"(mean={cert['lb_mean']:.6f} "
              f"hw={cert['lb_half_width']:.6f}, 95% t, R={R})")
        print(f"cert_gap={out['cert_gap']:.5f} (ub {out['ub']:.6f}"
              f"+-{out['ub_hw']:.6f}, decision={out['decision']})")
    return 0


def certify_replications(s, x_comp, ub_comp: float, ub_hw: float,
                         method: str = "ef", fresh_scenarios: int = 3000,
                         eval_samples: int = 1000, seed: int = 0) -> dict:
    """The certified optimality gap of a replicated run
    (sqlp_tpu/cli.py:252-293): a Student-t lower bound from the
    replications (``s.certified_lower_bound``, fresh Latin-hypercube
    streams of ``fresh_scenarios`` under the EF route), then, under the EF
    route, the decision among the compromise (``x_comp``, whose bound
    ``ub_comp`` +- ``ub_hw`` the caller measured), the EF argmins' average
    and the first two argmins, picked on a shared stratified panel of
    min(16384, ``eval_samples``) samples and re-evaluated on an
    independent one of ``eval_samples``.

    Returns {"cert", "decision", "x", "ub", "ub_hw", "selection" (name ->
    (mean, half-width, projection distance), or None), "lb_cert",
    "cert_gap", "seconds": {"certify", "select", "final"}}.
    """
    seconds = {"select": 0.0, "final": 0.0}
    t0 = time.perf_counter()
    kw = {"fresh_scenarios": fresh_scenarios} if method == "ef" else {}
    cert = s.certified_lower_bound(method=method, **kw)
    seconds["certify"] = time.perf_counter() - t0
    out = {"cert": cert, "decision": "compromise", "x": x_comp,
           "ub": ub_comp, "ub_hw": ub_hw, "selection": None}
    if "x_ef_per_rep" in cert:
        # the certification's EF argmins are free candidates: pick on a
        # shared panel, then re-evaluate the winner on an independent one
        # so the reported bound stays unbiased
        x_ef = np.asarray(cert["x_ef_per_rep"])
        cand = {"compromise": x_comp, "ef_avg": x_ef.mean(axis=0)}
        for r in range(min(2, x_ef.shape[0])):
            cand[f"ef_{r}"] = x_ef[r]
        t0 = time.perf_counter()
        sel = s.select_decision(cand, n_samples=min(16384, eval_samples),
                                seed=seed + 30_000)
        seconds["select"] = time.perf_counter() - t0
        out.update(decision=sel["name"], selection=sel["table"])
        if sel["name"] != "compromise":
            t0 = time.perf_counter()
            ub, hw, _ = s.evaluate_ci(
                x=sel["x"], min_samples=eval_samples,
                max_samples=eval_samples, seed=seed + 40_000,
                sampling="stratified")
            seconds["final"] = time.perf_counter() - t0
            out.update(x=sel["x"], ub=ub, ub_hw=hw)
    lo = cert["lb_mean"] - cert["lb_half_width"]
    hi = out["ub"] + out["ub_hw"]
    out.update(lb_cert=cert["lb_cert"],
               cert_gap=(hi - lo) / max(abs(hi), 1e-9), seconds=seconds)
    return out


def cmd_ef(args) -> int:
    import torch

    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.models.crash import solve_extensive_form
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.models.scenario import sample_deltas

    device = _device(args)
    if device is None:
        return 2
    config = _build_config(args)
    inst = load_instance(args.instance, dtype=config.jdtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    deltas = sample_deltas(gen, inst.scenario_model, args.scenarios)
    probs = torch.full((args.scenarios,), 1.0 / args.scenarios,
                       dtype=config.jdtype, device=device)
    t0 = time.time()
    x, obj, stats = solve_extensive_form(
        inst.arrays, inst.scenario_model, deltas, probs,
        PDHGConfig(tol=args.sub_tol, max_iters=args.sub_iters))
    print(f"EF over {args.scenarios} scenarios in {time.time() - t0:.1f}s "
          f"({int(stats['ef_iters'])} iterations, err "
          f"{float(stats['ef_err']):.2e}, "
          f"converged={bool(stats['ef_converged'])})", file=sys.stderr)
    print(f"objective={float(obj):.6f}")
    print(f"x={np.round(x.cpu().numpy(), 6).tolist()}")
    return 0


def cmd_evaluate(args) -> int:
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver

    device = _device(args)
    if device is None:
        return 2
    config = _build_config(args)
    inst = load_instance(args.instance, dtype=config.jdtype, device=device)
    solver = SDSolver(inst, config, seed=args.seed)
    x = np.asarray([float(v) for v in args.x.split(",")]) \
        if args.x else np.zeros(inst.n1)
    ub = solver.evaluate(x=x, n_samples=args.samples, seed=args.seed,
                         sampling=args.sampling)
    print(f"E[cost at x] ~= {ub:.6f} ({args.samples} samples)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sqlp_tpu_torch",
        description="two-stage regularized SD solver (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device of the whole run (cuda, cuda:N, "
                             "cpu)")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--dtype", default="float32",
                        choices=["float32", "float64"])
        sp.add_argument("--schedule", default="constant",
                        choices=["constant", "adaptive"])
        sp.add_argument("--rho", type=float, default=0.1,
                        help="prox weight (initial, for adaptive)")
        sp.add_argument("--max-scenarios", type=int, default=4096)
        sp.add_argument("--max-duals", type=int, default=2048)
        sp.add_argument("--max-cuts", type=int, default=96)
        sp.add_argument("--batch", type=int, default=1,
                        help="scenarios per iteration per epigraph")
        sp.add_argument("--dual-sig-bits", type=int, default=16)
        sp.add_argument("--sub-tol", type=float, default=1e-4)
        sp.add_argument("--sub-iters", type=int, default=60_000)
        sp.add_argument("--master-tol", type=float, default=1e-7)
        sp.add_argument("--master-iters", type=int, default=4_000)
        sp.add_argument("--sampling", default="iid",
                        choices=["iid", "antithetic", "stratified"],
                        help="scenario sampling scheme for the SD stream and "
                             "the MC evaluation (antithetic/stratified need "
                             "--batch > 1 for the SD stream)")
        sp.add_argument("--cut-refresh", type=int, default=0,
                        help="rebuild every live cut against the current "
                             "pool every this many iterations (0: never)")
        # a reference flag the port refuses for now (see _REFUSED)
        sp.add_argument("--mesh", type=int, default=0)

    ps = sub.add_parser("solve", help="run SD iterations on an instance")
    ps.add_argument("instance")
    ps.add_argument("--iters", type=int, default=1000)
    ps.add_argument("--log-every", type=int, default=100)
    ps.add_argument("--eval-samples", type=int, default=1000)
    ps.add_argument("--x0", default="zeros", choices=["zeros", "crash"],
                    help="start from zeros or from the first-stage x of a "
                         "sampled extensive form (--crash-scenarios)")
    ps.add_argument("--crash-scenarios", type=int, default=10)
    ps.add_argument("--epigraphs", type=int, default=1)
    ps.add_argument("--epi-lb", type=float, default=None,
                    help="per-epigraph recourse lower bound (default: "
                         "computed by one exact host LP)")
    ps.add_argument("--no-auto-capacity", action="store_true")
    ps.add_argument("--replications", type=int, default=1,
                    help="R > 1: R SD replications in lockstep, then the "
                         "compromise decision")
    ps.add_argument("--compromise-rho", type=float, default=1.0,
                    help="prox weight toward the incumbent average in the "
                         "compromise problem")
    ps.add_argument("--certify", action="store_true",
                    help="with --replications > 1: a certified statistical "
                         "lower bound and optimality gap")
    ps.add_argument("--certify-method", default="ef",
                    choices=["ef", "polish", "model"],
                    help="per-replication bound: 'ef' (extensive-form dual "
                         "certificates) or 'model' (the SD cut model's "
                         "minimum); 'polish' is refused (ROADMAP A12b)")
    ps.add_argument("--certify-scenarios", type=int, default=3000,
                    help="fresh Latin-hypercube certification scenarios per "
                         "replication (0: certify the SD stream)")
    # reference flags the port refuses for now (see _REFUSED)
    ps.add_argument("--target-gap", type=float, default=0.0)
    ps.add_argument("--proposal-sto", default=None)
    common(ps)
    ps.set_defaults(fn=cmd_solve)

    pe = sub.add_parser("ef", help="solve the sampled extensive form")
    pe.add_argument("instance")
    pe.add_argument("--scenarios", type=int, default=100)
    common(pe)
    pe.set_defaults(fn=cmd_ef)

    pv = sub.add_parser("evaluate", help="Monte-Carlo cost estimate at x")
    pv.add_argument("instance")
    pv.add_argument("--x", default=None, help="comma-separated first-stage x")
    pv.add_argument("--samples", type=int, default=10_000)
    common(pv)
    pv.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None) -> int:
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    args = build_parser().parse_args(argv)
    configure_torch()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
