"""Smoke test of the PyTorch port (sqlp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase, as a check
    python3 chip_smoke.py --iters 300 --phases device,b1,b3,main,cli

Builds the hand-written CUDA kernels from sqlp_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the main path gives it,
drives the main path (SD on ssn at the flagship CLI settings, then the
Monte-Carlo upper bound over 4096 scenarios) with the kernels' launch
counts reset just before and read just after, and runs the lands CLI
against the known optimum 381.8533. Any failed phase exits non-zero. The
last two lines of stdout are a JSON line of per-kernel numbers and the
JSON status line. Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

LANDS_OPT = 381.8533333
# elementwise agreement of a kernel with its plain version, relative to
# the output's scale: the two sum in different orders, so float32 parts
# of a 1e-7 ulp drift over the round's 80 (PDHG) / 25 (ADMM) steps;
# float64 drifts at 1e-16 per step
TOL = {"float32": 1e-4, "float64": 1e-10}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def agree(kernel, plain, dname):
    """(ok, max relative error) of a kernel's outputs against the plain
    version's: finite and within TOL."""
    import torch
    err = max(rel_err(o, r) for o, r in zip(kernel, plain))
    finite = all(bool(torch.isfinite(o).all()) for o in kernel)
    return finite and err <= TOL[dname], err


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    from sqlp_tpu_torch.ops.cuda import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip())
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    log(f"[device] kernels built+loaded in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {build.build_seconds:.2f}s) -> {build.library_path()}")


def _pdhg_case(name, B, dtype, per_el_q=False, seed=0):
    """Operands of one Halpern round at an instance's real shapes: the
    prepared recourse LP, a sampled RHS panel at x = 0 and the solver's
    initial primal weights; iterates from a short plain-version warm-up so
    the round starts mid-solve."""
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.models.scenario import sample_deltas
    from sqlp_tpu_torch.ops.cuda.pdhg_kernel import pdhg_halpern_round_ref
    from sqlp_tpu_torch.ops.pdhg import prepare_lp
    from sqlp_tpu_torch.sd.algorithm import _scenario_rhs

    dev = torch.device("cuda")
    inst = load_instance(name, dtype=dtype, device=dev)
    a = inst.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    deltas = sample_deltas(gen, inst.scenario_model, B)
    H = _scenario_rhs(a, inst.scenario_model, deltas,
                      torch.zeros(inst.n1, dtype=dtype, device=dev))
    ht = (H * (lp.flip * lp.row_scale)[None, :]).contiguous()
    big = 1e30
    lb = torch.where(torch.isfinite(lp.lb), lp.lb,
                     torch.full_like(lp.lb, -big)).contiguous()
    ub = torch.where(torch.isfinite(lp.ub), lp.ub,
                     torch.full_like(lp.ub, big)).contiguous()
    if per_el_q:
        q = (lp.q[None, :] * (1.0 + 0.1 * torch.rand(
            (B, lp.n), generator=gen, dtype=dtype, device=dev))).contiguous()
        qn = torch.linalg.norm(q, dim=-1)
    else:
        q = lp.q.contiguous()
        qn = torch.linalg.norm(q).expand(B)
    omega = qn / torch.clamp_min(torch.linalg.norm(ht, dim=-1), 1e-30)
    tau = (lp.step / omega).contiguous()
    sig = (lp.step * omega).contiguous()
    Y = torch.clamp(torch.zeros((B, lp.n), dtype=dtype, device=dev), lb, ub)
    L = torch.zeros((B, lp.m), dtype=dtype, device=dev)
    kh = torch.zeros(B, dtype=dtype, device=dev)
    K = lp.K.contiguous()
    is_eq = lp.is_eq.contiguous()
    Y, L, Yc, Lc = pdhg_halpern_round_ref(K, q, lb, ub, is_eq, ht, tau, sig,
                                          Y, L, kh, Y, L, 40)
    kh = torch.full((B,), 40.0, dtype=dtype, device=dev)
    return (K, q, lb, ub, is_eq, ht, tau, sig, Y.contiguous(),
            L.contiguous(), kh, Yc.contiguous(), Lc.contiguous())


def phase_b1(results):
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    n_inner = 80
    worst = 0.0
    for name, B, per_el in (("lands", 8, False), ("ssn", 2, False),
                            ("ssn", 4096, False), ("storm", 2, False),
                            ("ssn", 2, True)):
        for dtype in (torch.float32, torch.float64):
            args = _pdhg_case(name, B, dtype, per_el_q=per_el)
            out = pk.pdhg_halpern_round(*args, n_inner)
            torch.cuda.synchronize()
            ref = pk.pdhg_halpern_round_ref(*args, n_inner)
            torch.cuda.synchronize()
            abs_err = max(float((o - r).abs().max())
                          for o, r in zip(out, ref))
            dname = str(dtype).replace("torch.", "")
            ok, err = agree(out, ref, dname)
            reps = 3 if B >= 1024 else 20
            ms = time_ms(lambda: pk.pdhg_halpern_round(*args, n_inner), reps)
            plain_ms = time_ms(
                lambda: pk.pdhg_halpern_round_ref(*args, n_inner), reps)
            log(f"[b1] {name} B={B} q={'per-el' if per_el else 'shared'} "
                f"{dname}: max_rel_err={err:.3e} (tol {TOL[dname]:g}) "
                f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"pdhg_halpern_round disagrees with its "
                                     f"plain version on {name} B={B} {dname}")
            if dtype == torch.float32 and name == "ssn" and B == 2 \
                    and not per_el:
                results["pdhg_halpern_round"].update(ms=ms, plain_ms=plain_ms)
            worst = max(worst, abs_err)
    results["pdhg_halpern_round"]["max_abs_err"] = worst


def _master_after_steps(name, steps):
    """The assembled master QP of a real SD state after a few steps."""
    import torch
    from sqlp_tpu_torch.config import SDConfig, autoscale_capacities
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.algorithm import _quad_scalar_schedule
    from sqlp_tpu_torch.sd.driver import SDSolver
    from sqlp_tpu_torch.sd.master import assemble_master

    cfg = autoscale_capacities(SDConfig(quad_schedule="adaptive",
                                        quad_scalar_init=1e-3,
                                        pdhg=_flagship_pdhg()), 300)
    inst = load_instance(name, device=torch.device("cuda"))
    s = SDSolver(inst, cfg, seed=0)
    for _ in range(steps):
        s.step()
    rho, *_ = _quad_scalar_schedule(s.state, s.config)
    return assemble_master(s.arrays, s.espec, s.state, rho), s.config.qp


def _flagship_pdhg():
    from sqlp_tpu_torch.config import PDHGConfig
    return PDHGConfig(tol=1e-4, max_iters=60_000)


def phase_b3(results):
    import torch
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    from sqlp_tpu_torch.ops.prox_qp import admm_operands

    worst = 0.0
    for name in ("ssn", "storm"):
        (p_diag, g, A, l, u, is_eq), qp = _master_after_steps(name, 3)
        ops64 = admm_operands(p_diag, g, A, l, u, is_eq, qp, qp.rho)
        # a few intervals of the plain loop first: start mid-solve
        ops64 = list(ops64)
        ops64[7:] = ak.admm_round_ref(*ops64, 100, qp.over_relax, qp.sigma)
        ops64 = [t.contiguous() for t in ops64]
        for dtype in (torch.float32, torch.float64):
            ops = [t.to(dtype).contiguous() for t in ops64]
            out = ak.admm_round(*ops, qp.check_every, qp.over_relax, qp.sigma)
            torch.cuda.synchronize()
            ref = ak.admm_round_ref(*ops, qp.check_every, qp.over_relax,
                                    qp.sigma)
            torch.cuda.synchronize()
            abs_err = max(float((o - r).abs().max())
                          for o, r in zip(out, ref))
            dname = str(dtype).replace("torch.", "")
            ok, err = agree(out, ref, dname)
            ms = time_ms(lambda: ak.admm_round(*ops, qp.check_every,
                                               qp.over_relax, qp.sigma), 50)
            plain_ms = time_ms(lambda: ak.admm_round_ref(
                *ops, qp.check_every, qp.over_relax, qp.sigma), 50)
            mA, nz = ops[0].shape
            log(f"[b3] {name} master nz={nz} mA={mA} {dname}: "
                f"max_rel_err={err:.3e} (tol {TOL[dname]:g}) "
                f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"admm_round disagrees with its plain "
                                     f"version on {name} {dname}")
            if dtype == torch.float64 and name == "ssn":
                results["admm_round"].update(ms=ms, plain_ms=plain_ms)
            worst = max(worst, abs_err)
    results["admm_round"]["max_abs_err"] = worst


def phase_main(results, iters):
    import numpy as np
    import torch
    from sqlp_tpu_torch.config import QPConfig, SDConfig, autoscale_capacities
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    from sqlp_tpu_torch.sd.driver import SDSolver

    # the flagship CLI configuration (sqlp_tpu_torch/cli.py defaults with
    # --schedule adaptive --rho 1e-3), capacities autoscaled to iters
    cfg = SDConfig(dtype="float32", quad_schedule="adaptive",
                   quad_scalar_init=1e-3, max_cuts=96, scenarios_per_iter=1,
                   pdhg=_flagship_pdhg(),
                   qp=QPConfig(tol=1e-7, max_iters=4_000))
    cfg = autoscale_capacities(cfg, iters)
    dev = torch.device("cuda")
    pk.launches = 0
    ak.launches = 0
    inst = load_instance("ssn", dtype=cfg.jdtype, device=dev)
    solver = SDSolver(inst, cfg, x0=np.zeros(inst.n1), seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = solver.run(iters)
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ub, hw, n = solver.evaluate_ci(min_samples=4096, max_samples=4096,
                                   seed=1)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    counts = {"pdhg_halpern_round": pk.launches, "admm_round": ak.launches}
    lb = solver.lower_estimate
    log(f"[main] ssn {iters} iters in {sd_s:.2f}s ({iters / sd_s:.2f} it/s)"
        f" lb_est={lb:.6f} mc_ub={ub:.6f} +- {hw:.4f} (N={n}, "
        f"{eval_s:.2f}s) host_fallbacks={solver.host_fallback_count}")
    log("[main] last step: " + " ".join(
        f"{k}={float(last[k]):.6g}" for k in (
            "pdhg_rounds", "pdhg_iters", "pdhg_err_max", "pdhg_converged",
            "qp_iters", "qp_err", "qp_converged", "n_duals", "n_cuts_live",
            "crossover_accepted")))
    log(f"[main] launches: {json.dumps(counts)}")
    for k, v in counts.items():
        results[k]["launches"] = v
    if not all(math.isfinite(v) for v in (lb, ub, hw)):
        raise AssertionError(f"non-finite bounds lb={lb} ub={ub} hw={hw}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")


def phase_cli():
    # 4096 MC samples keep the upper bound's sampling half-width (about 2
    # on lands) well inside the 6-unit band
    cmd = [sys.executable, "-m", "sqlp_tpu_torch", "solve", "lands",
           "--iters", "200", "--device", "cuda", "--eval-samples", "4096"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    dt = time.perf_counter() - t0
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", proc.stdout)
    log(f"[cli] {' '.join(cmd[1:])}: rc={proc.returncode} in {dt:.1f}s "
        f"{m.group(0) if m else proc.stderr[-2000:]}")
    if proc.returncode != 0 or m is None:
        raise AssertionError("lands CLI run failed")
    lb, ub = float(m.group(1)), float(m.group(2))
    if abs(lb - LANDS_OPT) >= 6.0 or abs(ub - LANDS_OPT) >= 6.0:
        raise AssertionError(f"lands bounds lb={lb} ub={ub} not within 6 of "
                             f"{LANDS_OPT}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=300,
                    help="SD iterations of the ssn main path")
    ap.add_argument("--phases", default="device,b1,b3,main,cli")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA device", file=sys.stderr)
        return 1
    from sqlp_tpu_torch.utils.torchsetup import configure_torch
    configure_torch()

    src = "sqlp_tpu_torch/csrc/"
    results = {
        "pdhg_halpern_round": {
            "name": "pdhg_halpern_round", "route": "cuda",
            "source": src + "pdhg_halpern_round.cu",
            "replaces": "sqlp_tpu/ops/pallas/pdhg_kernel.py:236"},
        "admm_round": {
            "name": "admm_round", "route": "cuda",
            "source": src + "admm_round.cu",
            "replaces": "sqlp_tpu/ops/pallas/admm_kernel.py:95"},
    }
    t0 = time.perf_counter()
    for ph in phases:
        tp = time.perf_counter()
        if ph == "device":
            phase_device()
        elif ph == "b1":
            phase_b1(results)
        elif ph == "b3":
            phase_b3(results)
        elif ph == "main":
            phase_main(results, args.iters)
        elif ph == "cli":
            phase_cli()
        else:
            raise ValueError(f"unknown phase {ph}")
        log(f"[{ph}] phase done in {time.perf_counter() - tp:.1f}s")
    log(f"[total] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
