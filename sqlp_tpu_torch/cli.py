"""Command-line entry point of the PyTorch port.

Port of record: ``sqlp_tpu/cli.py`` (``cmd_solve`` :39-183,
``_solve_replicated`` :192-293, ``cmd_ef`` :296-318, ``cmd_evaluate``
:321-333, the parser :341-470):

    python -m sqlp_tpu_torch solve ssn --iters 3000 --schedule adaptive --rho 1e-3
    python -m sqlp_tpu_torch solve ssn --iters 3000 --eval-every 500 --stop-gap 0.01
    python -m sqlp_tpu_torch solve ssn --iters 3000 --log run.jsonl \
        --checkpoint run.npz --checkpoint-every 500 --no-auto-capacity
    python -m sqlp_tpu_torch solve ssn --iters 1000 --resume run.npz \
        --no-auto-capacity
    python -m sqlp_tpu_torch solve lands --proposal-sto proposal.sto
    python -m sqlp_tpu_torch solve ssn --replications 8 --certify
    python -m sqlp_tpu_torch solve lands --replications 4 --target-gap 0.01
    python -m sqlp_tpu_torch ef lands --scenarios 100
    python -m sqlp_tpu_torch evaluate transship --samples 20000
    python -m sqlp_tpu_torch bench [--skip-sd-gap | --cpu-baseline-only]

runs on the chosen device (``--device``, default ``cuda``; there is no
silent CPU fallback). ``solve`` runs SD in chunks; at the chunk
boundaries it logs (``--log-every``, into the JSONL file ``--log``),
estimates the Monte-Carlo upper bound (``--eval-every``), sharpens the
dual pool with host-exact duals (``--sharpen-every``), writes the
checkpoint ``--checkpoint`` (``--checkpoint-every``) and applies the
stopping rules (``--stop-gap``, ``--stop-stall-window``), each exactly at
the multiples of its own period, and ends with a checkpoint, the
Monte-Carlo upper bound and its confidence half-width. ``--resume``
continues a checkpoint's trajectory (its state and generator),
``--profile DIR`` writes a ``torch.profiler`` trace of the loop into DIR,
``--proposal-sto`` draws the scenario stream from an importance-sampling
proposal. With ``--replications R`` it runs R replications in lockstep
and ends with the compromise decision and its bound; with ``--certify``
also with a certified statistical lower bound, the decision picked among
the compromise and the certification's EF argmins, and the certified
optimality gap (:func:`certify_replications`); with ``--target-gap`` it
certifies every ``--certify-every`` iterations and stops at the target
certified gap, ending with one JSON line. ``ef`` solves a sampled
extensive form, ``evaluate`` estimates the expected cost of a first-stage
decision, ``bench`` runs the benchmark sections (``bench.py``). The
replicated path refuses ``--proposal-sto`` and a mesh (as
the reference does) and the run-management flags (which the reference's
replicated path ignores).

``solve --mesh N`` shards the scenario stores over N ranks, the dual pool
too with ``--shard-duals``; ``--mesh-duals M`` makes the mesh 2-D, M x N
(duals x scenarios). One rank is one process: without ``--coordinator``
the command starts the M N ranks itself on this host (rank i on
``cuda:(i % device_count)``); with ``--coordinator HOST:PORT
--num-processes P --process-id i`` each process is one rank of P, started
by the user on any host. The ranks share a card over Gloo, or each has its
own over NCCL (``parallel/distributed.py``). Only rank 0 prints, logs and
writes the checkpoint; ``--profile DIR`` writes one trace per rank into
DIR/rank<i>. The run ends by checking that every replicated state field
holds the same bits on every rank::

    python -m sqlp_tpu_torch solve ssn --mesh 2 --shard-duals
    python -m sqlp_tpu_torch solve lands --mesh 2 --mesh-duals 2 \
        --device cpu
    python -m sqlp_tpu_torch solve ssn --mesh 2 --coordinator host0:29500 \
        --num-processes 2 --process-id 0      # and --process-id 1
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import sys
import time

import numpy as np

# flag -> (the values the port takes, why it takes no other)
_REFUSED = {
    "cpu_devices_per_process": (
        (None,), "torch has no virtual devices: the port runs one rank "
        "per process (--mesh N starts N of them, --coordinator joins one)"),
}
# single-run flags the replicated path does not take
_SINGLE_RUN = ("log", "checkpoint", "checkpoint_every", "resume", "profile")


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

    for flag, (taken, why) in _REFUSED.items():
        value = getattr(args, flag, taken[0])
        if value not in taken:
            print(f"error: --{flag.replace('_', '-')} {value} is not ported "
                  f"to sqlp_tpu_torch: {why}", file=sys.stderr)
            return None
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return None
    return device


def _mesh_ranks(args) -> int:
    """The ranks the mesh flags ask for (<= 1: no mesh)."""
    if not args.mesh:
        return 0
    return args.mesh * (args.mesh_duals or 1)


def _mesh_error(args):
    """Why the mesh flags cannot run as given, or None."""
    n = _mesh_ranks(args)
    if args.shard_duals and not args.mesh:
        return "--shard-duals needs --mesh N (it shards the dual pool " \
               "over the mesh)"
    if args.mesh_duals and not args.mesh:
        return "--mesh-duals needs --mesh N (the mesh is --mesh-duals x " \
               "--mesh)"
    if args.coordinator and n <= 1:
        return "--coordinator needs a mesh of more than one rank (--mesh N)"
    if args.coordinator and args.num_processes != n:
        return f"--num-processes {args.num_processes} must equal the " \
               f"mesh's {n} ranks (one rank per process)"
    if args.coordinator and not 0 <= args.process_id < args.num_processes:
        return f"--process-id {args.process_id} outside [0, " \
               f"{args.num_processes})"
    if n > 1 and getattr(args, "sharpen_every", 0):
        return "--sharpen-every runs on a single device: host dual " \
               "sharpening does not run on a mesh"
    return None


def _rank_device(device, rank: int):
    """Rank ``rank``'s device: a CUDA run without an index puts rank i on
    cuda:(i % device_count)."""
    import torch

    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, args, n: int, port: int) -> None:
    """One local rank of ``solve --mesh`` without ``--coordinator``."""
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    args = copy.copy(args)
    args.coordinator = f"127.0.0.1:{port}"
    args.num_processes, args.process_id = n, rank
    configure_torch()
    rc = args.fn(args)
    if rc:
        sys.exit(rc)


def _spawn_ranks(args, n: int) -> int:
    """Start the mesh's n ranks on this host, one process each, and wait
    for them; a rank that fails fails the command."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_rank_main, args=(args, n, _free_port()),
                           nprocs=n, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        print(f"error: {e}", file=sys.stderr)
        return e.exit_code or 1
    except mp.ProcessRaisedException as e:
        print(f"error: a rank failed:\n{e}", file=sys.stderr)
        return 1
    return 0


def _solve_only(args) -> bool:
    """False after an error message when a mesh flag is given to a
    command other than ``solve`` (the reference ignores them there)."""
    given = [f"--{f.replace('_', '-')}" for f in
             ("mesh", "mesh_duals", "shard_duals", "coordinator")
             if getattr(args, f)]
    if given:
        print(f"error: {'/'.join(given)} apply to solve only; "
              f"{args.cmd} runs on one device", file=sys.stderr)
    return not given


def cmd_solve(args) -> int:
    if args.replications > 1 and (args.mesh or args.shard_duals
                                  or args.mesh_duals or args.proposal_sto):
        # the reference's own refusal (sqlp_tpu/cli.py:75-82)
        print("error: --mesh/--shard-duals/--proposal-sto are not "
              "supported with --replications > 1 (replications batch "
              "on a single device program); drop one of the flags",
              file=sys.stderr)
        return 2
    single = [f"--{f.replace('_', '-')}" for f in _SINGLE_RUN
              if getattr(args, f)]
    if args.replications > 1 and single:
        print(f"error: {'/'.join(single)} "
              f"{'is' if len(single) == 1 else 'are'} not supported with "
              f"--replications > 1 (logging, checkpoints, resume and "
              f"profiling follow a single run); drop the flag",
              file=sys.stderr)
        return 2
    if (args.certify or args.target_gap) and args.replications < 2:
        print("error: --certify and --target-gap need --replications R > 1 "
              "(the bound is a Student-t interval over R replications)",
              file=sys.stderr)
        return 2
    err = _mesh_error(args)
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    n = _mesh_ranks(args)
    if n <= 1:
        return _solve(args, device)
    if not args.coordinator:
        return _spawn_ranks(args, n)
    from sqlp_tpu_torch.parallel import distributed

    device = _rank_device(device, args.process_id)
    distributed.init_distributed(args.coordinator, args.num_processes,
                                 args.process_id, device)
    try:
        return _solve(args, device, rank=args.process_id)
    finally:
        distributed.shutdown()


def _silent(*a, **k) -> None:
    pass


def _solve(args, device, rank: int = 0) -> int:
    """``solve`` on ``device``; on a mesh, this process's rank of it."""
    import torch

    from sqlp_tpu_torch.config import autoscale_capacities
    from sqlp_tpu_torch.models.crash import crash_x0
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver
    from sqlp_tpu_torch.sd.state import default_epigraph_spec
    from sqlp_tpu_torch.sd.stopping import GapRule, LowerBoundStabilization
    from sqlp_tpu_torch.utils.checkpoint import load_state, save_state
    from sqlp_tpu_torch.utils.metrics import MetricsLogger
    from sqlp_tpu_torch.utils.profiling import trace

    say = print if rank == 0 else _silent
    config = _build_config(args)
    if not args.no_auto_capacity:
        config = autoscale_capacities(config, args.iters,
                                      n_epi=args.epigraphs,
                                      mesh_devices=args.mesh)
    inst = load_instance(args.instance, dtype=config.jdtype, device=device)
    say(f"{inst.name}: n1={inst.n1} m1={inst.m1} n2={inst.n2} "
        f"m2={inst.m2} R={inst.n_rv} S={config.max_scenarios} "
        f"D={config.max_dual_vertices} device={device}", file=sys.stderr)
    if args.x0 == "crash":
        x0, ef_obj, _ = crash_x0(inst, n_scenarios=args.crash_scenarios,
                                 seed=args.seed)
        x0 = x0.cpu().numpy().astype(np.float64)
        say(f"crash x0 from {args.crash_scenarios}-scenario EF "
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
    proposal = None
    if args.proposal_sto:
        from sqlp_tpu_torch.models.instance import load_proposal
        proposal = load_proposal(inst, args.proposal_sto,
                                 dtype=config.jdtype)
        say(f"importance sampling from proposal {args.proposal_sto}",
            file=sys.stderr)
    solver = SDSolver(inst, config, espec=espec, x0=x0, seed=args.seed,
                      n_epi=E, proposal=proposal,
                      mesh_devices=args.mesh if _mesh_ranks(args) > 1 else 0,
                      shard_duals=args.shard_duals and _mesh_ranks(args) > 1,
                      mesh_shape=(args.mesh_duals, args.mesh)
                      if args.mesh_duals and _mesh_ranks(args) > 1 else None)
    mesh = solver.mesh
    if mesh is not None:
        from sqlp_tpu_torch.parallel import distributed
        from sqlp_tpu_torch.parallel.mesh import check_replicated
        say(f"mesh {mesh} over {distributed.backend()}: "
            f"{distributed.layout_summary()}", file=sys.stderr, flush=True)
    say(f"recourse lower bound: {solver.recourse_lb:.6g}"
        + (" (auto)" if args.epi_lb is None
           else f" (user: {args.epi_lb:g})"), flush=True)
    if args.resume:
        solver.state = load_state(args.resume, template=solver.state,
                                  generator=solver.generator, mesh=mesh)
        say(f"resumed from {args.resume} at iter {int(solver.state.it)}",
            file=sys.stderr)

    stab = LowerBoundStabilization(window=args.stop_stall_window,
                                   rel_tol=args.stop_stall_tol) \
        if args.stop_stall_window else None
    gap_rule = GapRule(rel_gap=args.stop_gap) if args.stop_gap else None
    if gap_rule and not args.eval_every:
        say("--stop-gap needs --eval-every to estimate the upper bound; "
            "ignoring", file=sys.stderr)
        gap_rule = None
    # iterations run in chunks that end at the next multiple of any period
    # that is set, so every periodic action fires at the multiples of its
    # own period; the stall rule reads the multiples of the smallest one
    periods = [p for p in (args.log_every, args.eval_every,
                           args.checkpoint_every, args.sharpen_every) if p]
    base = min(periods) if periods else args.iters
    logger = MetricsLogger(args.log if rank == 0 else None)
    profile = args.profile
    if profile and mesh is not None:
        profile = os.path.join(profile, f"rank{rank}")
    t0 = time.time()
    done = 0
    with trace(profile):
        while done < args.iters:
            nxt = min([(done // p + 1) * p for p in periods] + [args.iters])
            last = solver.run(nxt - done)
            done = nxt
            it = int(last["it"])
            stopped = None
            if args.log_every and done % args.log_every == 0:
                logger.log(last, it=it)
                say(f"iter {it}: lb_est={last['cand_est']:.4f} "
                    f"rho={last['rho']:.4g} duals={int(last['n_duals'])} "
                    f"cuts={int(last['n_cuts_live'])}", file=sys.stderr)
            if args.eval_every and done % args.eval_every == 0:
                # the stop-gap test inflates ub by its sampling half-width,
                # so a lucky draw cannot stop SD early
                ub, ub_hw, _ = solver.evaluate_ci(
                    min_samples=args.eval_samples,
                    max_samples=args.eval_samples, seed=args.seed + it,
                    sampling=args.sampling)
                logger.log({"it": it, "mc_upper_bound": ub,
                            "mc_half_width": ub_hw})
                say(f"iter {it}: mc_ub={ub:.4f} (+-{ub_hw:.4f})",
                    file=sys.stderr)
                if gap_rule and gap_rule.check(solver.lower_estimate, ub,
                                               ub_half_width=ub_hw):
                    stopped = f"gap <= {args.stop_gap:g} at iter {it}"
            if args.sharpen_every and done % args.sharpen_every == 0 \
                    and done < args.iters:
                sh = solver.sharpen_duals_host(k=args.sharpen_k)
                logger.log({"it": it, "sharpen": sh})
                say(f"iter {it}: sharpened {sh['n_solved']} scenarios "
                    f"(+{sh['n_new']} exact duals, max argmax slack "
                    f"{sh['max_slack']:.3g})", file=sys.stderr)
            if stab and (done % base == 0 or done == args.iters) \
                    and stab.update(float(last["inc_est"])):
                stopped = stopped or \
                    f"incumbent estimate stabilized at iter {it}"
            if args.checkpoint and args.checkpoint_every \
                    and done % args.checkpoint_every == 0:
                save_state(args.checkpoint, solver.state, solver.generator,
                           mesh=mesh, instance=inst.name)
            if stopped:
                say(f"stopping rule: {stopped}", file=sys.stderr)
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    elapsed = time.time() - t0

    if args.checkpoint:
        save_state(args.checkpoint, solver.state, solver.generator,
                   mesh=mesh, instance=inst.name)
    ub, ub_hw, ub_n = solver.evaluate_ci(min_samples=args.eval_samples,
                                         max_samples=args.eval_samples,
                                         seed=args.seed + 1,
                                         sampling=args.sampling)
    logger.log({"it": int(solver.state.it), "mc_upper_bound": ub,
                "mc_half_width": ub_hw, "mc_samples": ub_n, "final": True})
    logger.close()
    if mesh is not None:
        n_fields = check_replicated(solver.state, mesh)
        say(f"mesh: {n_fields} replicated state fields bitwise equal on "
            f"{mesh.size} ranks", file=sys.stderr)
    say(f"done: {done} iters in {elapsed:.1f}s "
        f"({done / max(elapsed, 1e-9):.1f} it/s)", file=sys.stderr)
    say(f"lb_est={solver.lower_estimate:.6f} mc_ub={ub:.6f} "
        f"(95% +- {ub_hw:.4f}, N={ub_n})")
    say(f"x_incumbent={np.round(solver.x_incumbent, 6).tolist()}")
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
    if args.target_gap:
        # certified-gap stopping: SD in rounds, a certified bound every
        # --certify-every iterations (free model route first, escalating
        # to the configured route), stop at the target certified gap
        method = args.certify_method if args.certify else \
            ("polish" if inst.n1 <= 32 else "ef")
        kw = ({"fresh_scenarios": args.certify_scenarios}
              if method in ("ef", "polish") else {})
        res = s.solve_to_certified_gap(
            args.target_gap, args.iters, certify_every=args.certify_every,
            method=method, compromise_rho=args.compromise_rho,
            max_ub_samples=max(args.eval_samples, 65536),
            seed=args.seed + 7000, verbose=True, **kw)
        x_comp = res.pop("x_compromise")
        print(f"{'stopped at' if res['stopped'] else 'exhausted'} "
              f"{res['iters']} iters in {time.time() - t0:.1f}s "
              f"(certified gap {res['cert_gap']:.5f}, "
              f"target {args.target_gap:g})", file=sys.stderr)
        print(f"x_compromise={np.round(x_comp, 6).tolist()}")
        print(json.dumps(res))
        return 0
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
    streams of ``fresh_scenarios`` under the EF and polish routes), then,
    under the EF route, the decision among the compromise (``x_comp``, whose bound
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
    kw = ({"fresh_scenarios": fresh_scenarios}
          if method in ("ef", "polish") else {})
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

    device = _device(args) if _solve_only(args) else None
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

    device = _device(args) if _solve_only(args) else None
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


def cmd_bench(args) -> int:
    from sqlp_tpu_torch import bench
    return bench.main([f for f, on in (("--skip-sd-gap", args.skip_sd_gap),
                                       ("--cpu-baseline-only",
                                        args.cpu_baseline_only)) if on])


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
        sp.add_argument("--mesh", type=int, default=0,
                        help="solve: shard the scenario stores over this "
                             "many ranks, one process each (0: one "
                             "device); without --coordinator the command "
                             "starts them on this host")
        sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="solve: join a mesh as one rank; rank 0's "
                             "address, the same in every process, with "
                             "--num-processes and a distinct --process-id")
        sp.add_argument("--num-processes", type=int, default=1)
        sp.add_argument("--process-id", type=int, default=0)
        sp.add_argument("--shard-duals", action="store_true",
                        help="with --mesh, also shard the dual-vertex pool")
        sp.add_argument("--mesh-duals", type=int, default=0,
                        help="with --mesh N, a 2-D (duals x scenarios) "
                             "mesh of shape (this, N): the dual pool and "
                             "the scenario stores each shard over their "
                             "own axis (this x N ranks)")
        # a reference flag the port refuses (see _REFUSED)
        sp.add_argument("--cpu-devices-per-process", type=int, default=None)

    ps = sub.add_parser("solve", help="run SD iterations on an instance")
    ps.add_argument("instance")
    ps.add_argument("--iters", type=int, default=1000)
    ps.add_argument("--log", default=None, metavar="PATH",
                    help="append one JSON record per --log-every period, "
                         "Monte-Carlo bound and sharpening, and a final "
                         "record, to this JSONL file")
    ps.add_argument("--log-every", type=int, default=100)
    ps.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="write the solver state and its generator to this "
                         ".npz every --checkpoint-every iterations and at "
                         "the end")
    ps.add_argument("--checkpoint-every", type=int, default=0)
    ps.add_argument("--resume", default=None, metavar="PATH",
                    help="continue from a checkpoint (the capacities must "
                         "match: pass the run's own, with "
                         "--no-auto-capacity); runs --iters more "
                         "iterations")
    ps.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler trace of the iteration loop "
                         "(host operators and CUDA kernels), written into "
                         "DIR as a Chrome trace")
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
                         "certificates: high-dimensional first stages, "
                         "e.g. ssn), 'polish' (level bundle: exact on "
                         "low-dimensional instances), 'model' (free; "
                         "where the SD cut model is already tight, e.g. "
                         "storm)")
    ps.add_argument("--certify-scenarios", type=int, default=3000,
                    help="fresh Latin-hypercube certification scenarios per "
                         "replication (0: certify the SD stream)")
    ps.add_argument("--target-gap", type=float, default=0.0,
                    help="with --replications > 1: run SD in rounds, "
                         "certify a statistical lower bound every "
                         "--certify-every iterations (free cut-model route "
                         "first, escalating to --certify-method when it "
                         "misses) and stop once the certified optimality "
                         "gap crosses this target; the confidence is split "
                         "over the planned looks. Unlike --stop-gap this "
                         "stops on a valid bound, not the lb_est proxy")
    ps.add_argument("--certify-every", type=int, default=0,
                    help="certification cadence (iterations) for "
                         "--target-gap; 0 = four rounds across --iters")
    ps.add_argument("--eval-every", type=int, default=0,
                    help="Monte-Carlo upper bound every this many "
                         "iterations (0: only at the end)")
    ps.add_argument("--stop-gap", type=float, default=0.0,
                    help="stop when (mc_ub - lb_est) relative gap falls "
                         "below this (needs --eval-every)")
    ps.add_argument("--stop-stall-window", type=int, default=0,
                    help="stop when the incumbent estimate moved less than "
                         "--stop-stall-tol over this many checks (one at "
                         "each multiple of the smallest period set)")
    ps.add_argument("--stop-stall-tol", type=float, default=1e-4)
    ps.add_argument("--sharpen-every", type=int, default=0,
                    help="every N iterations re-solve the home scenarios "
                         "of the pool's top-K argmax winners exactly on "
                         "the host and push the exact basic duals into the "
                         "pool (not at the final iteration); 0 = off")
    ps.add_argument("--sharpen-k", type=int, default=32,
                    help="top-K winners per --sharpen-every round")
    ps.add_argument("--proposal-sto", default=None, metavar="PATH",
                    help="importance sampling: draw the SD scenario stream "
                         "from this alternate .sto file (the same random "
                         "positions) and weight each scenario by the "
                         "exact density ratio, on the device")
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

    pb = sub.add_parser("bench", help="run the benchmark sections, one "
                        "JSON line each (sqlp_tpu_torch/bench.py)")
    pb.add_argument("--skip-sd-gap", action="store_true",
                    help="only the LP-throughput section")
    pb.add_argument("--cpu-baseline-only", action="store_true",
                    help="run on the CPU at the CPU depths (without it the "
                         "bench needs a card)")
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    args = build_parser().parse_args(argv)
    configure_torch()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
