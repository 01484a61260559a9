"""Command-line entry point of the PyTorch port.

Port of record: ``sqlp_tpu/cli.py`` (``cmd_solve`` :39-189, the parser
:341-470), the ``solve`` subcommand only:

    python -m sqlp_tpu_torch solve ssn --iters 3000 --schedule adaptive --rho 1e-3

runs SD on the chosen device (``--device``, default ``cuda``; there is no
silent CPU fallback) and ends with the Monte-Carlo upper bound and its
confidence half-width. Flags of the reference CLI that the port does not
carry yet are accepted by the parser and refused with the ROADMAP item
that will bring them.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# flag -> (value that means "not requested", ROADMAP item)
_REFUSED = {
    "x0": ("zeros", "A11 (crash_x0 / extensive form)"),
    "replications": (1, "A10 (replications + compromise)"),
    "certify": (False, "A12 (certified bounds)"),
    "mesh": (0, "A14 (multi-device)"),
    "proposal_sto": (None, "A13 (importance sampling proposal)"),
    "cut_refresh": (0, "A7 (periodic cut refresh)"),
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
        pdhg=PDHGConfig(tol=args.sub_tol, max_iters=args.sub_iters),
        qp=QPConfig(tol=args.master_tol, max_iters=args.master_iters),
    )


def cmd_solve(args) -> int:
    import torch

    from sqlp_tpu_torch.config import autoscale_capacities
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver
    from sqlp_tpu_torch.sd.state import default_epigraph_spec

    for flag, (off, item) in _REFUSED.items():
        if getattr(args, flag) != off:
            print(f"error: --{flag.replace('_', '-')} is not ported to "
                  f"sqlp_tpu_torch yet (ROADMAP {item})", file=sys.stderr)
            return 2
    if args.sampling != "iid":
        print("error: --sampling other than iid is not ported yet "
              "(ROADMAP A2)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 2

    config = _build_config(args)
    if not args.no_auto_capacity:
        config = autoscale_capacities(config, args.iters,
                                      n_epi=args.epigraphs)
    inst = load_instance(args.instance, dtype=config.jdtype, device=device)
    print(f"{inst.name}: n1={inst.n1} m1={inst.m1} n2={inst.n2} "
          f"m2={inst.m2} R={inst.n_rv} S={config.max_scenarios} "
          f"D={config.max_dual_vertices} device={device}", file=sys.stderr)
    E = args.epigraphs
    espec = None
    if args.epi_lb is not None:
        espec = default_epigraph_spec(E, 1.0 / E, args.epi_lb,
                                      dtype=config.jdtype, device=device)
    solver = SDSolver(inst, config, espec=espec, x0=np.zeros(inst.n1),
                      seed=args.seed, n_epi=E)
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
                                         seed=args.seed + 1)
    print(f"done: {done} iters in {elapsed:.1f}s "
          f"({done / max(elapsed, 1e-9):.1f} it/s)", file=sys.stderr)
    print(f"lb_est={solver.lower_estimate:.6f} mc_ub={ub:.6f} "
          f"(95% +- {ub_hw:.4f}, N={ub_n})")
    print(f"x_incumbent={np.round(solver.x_incumbent, 6).tolist()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sqlp_tpu_torch",
        description="two-stage regularized SD solver (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("solve", help="run SD iterations on an instance")
    ps.add_argument("instance")
    ps.add_argument("--device", default="cuda",
                    help="torch device of the whole run (cuda, cuda:N, cpu)")
    ps.add_argument("--iters", type=int, default=1000)
    ps.add_argument("--log-every", type=int, default=100)
    ps.add_argument("--eval-samples", type=int, default=1000)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ps.add_argument("--schedule", default="constant",
                    choices=["constant", "adaptive"])
    ps.add_argument("--rho", type=float, default=0.1,
                    help="prox weight (initial, for adaptive)")
    ps.add_argument("--max-scenarios", type=int, default=4096)
    ps.add_argument("--max-duals", type=int, default=2048)
    ps.add_argument("--max-cuts", type=int, default=96)
    ps.add_argument("--batch", type=int, default=1,
                    help="scenarios per iteration per epigraph")
    ps.add_argument("--epigraphs", type=int, default=1)
    ps.add_argument("--epi-lb", type=float, default=None,
                    help="per-epigraph recourse lower bound (default: "
                         "computed by one exact host LP)")
    ps.add_argument("--dual-sig-bits", type=int, default=16)
    ps.add_argument("--sub-tol", type=float, default=1e-4)
    ps.add_argument("--sub-iters", type=int, default=60_000)
    ps.add_argument("--master-tol", type=float, default=1e-7)
    ps.add_argument("--master-iters", type=int, default=4_000)
    ps.add_argument("--no-auto-capacity", action="store_true")
    ps.add_argument("--sampling", default="iid",
                    choices=["iid", "antithetic", "stratified"])
    # reference flags the port refuses for now (see _REFUSED)
    ps.add_argument("--x0", default="zeros", choices=["zeros", "crash"])
    ps.add_argument("--replications", type=int, default=1)
    ps.add_argument("--certify", action="store_true")
    ps.add_argument("--mesh", type=int, default=0)
    ps.add_argument("--proposal-sto", default=None)
    ps.add_argument("--cut-refresh", type=int, default=0)
    ps.set_defaults(fn=cmd_solve)
    return p


def main(argv=None) -> int:
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    args = build_parser().parse_args(argv)
    configure_torch()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
