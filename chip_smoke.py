"""Smoke test of the PyTorch port (sqlp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase, as a check
    python3 chip_smoke.py --iters 300 --rep-iters 100 \
        --phases device,b1,b2,b3,main,replicated,small,cli
    python3 chip_smoke.py --phases device,certify,cli_cert
    python3 chip_smoke.py --phases device,certify,cert_polish,cli_gap
    python3 chip_smoke.py --phases device,cli_run
    python3 chip_smoke.py --phases device,mesh
    python3 chip_smoke.py --phases device,mesh_nccl     # on 4 cards
    python3 chip_smoke.py --phases device,storm --storm-iters 1500
    python3 chip_smoke.py --phases device,surface
    python3 chip_smoke.py --phases device,bench
    python3 chip_smoke.py --phases device,bench_full \
        --bench-sections ssn_time_to_gap

Builds the hand-written CUDA kernels from sqlp_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the paths give it (every
variant of both PDHG rounds, row-block, cluster, tile, stream, grid and
small, wherever the variant takes the shape; the float32 stream and grid
rounds and the small rounds of both dtypes also to the row-block round's
bits, and the tile rounds of both dtypes to the bits the first tile design
gave at fixed inputs, TILE_DIGESTS), and
drives five paths with the kernels' launch counts reset just before and
read just after each: the main path (SD on ssn at the flagship CLI
settings, then the Monte-Carlo upper bound over 4096 scenarios; run twice,
`main` and `main2`, whose seeded bounds must agree bitwise) and the
replicated path (8 lockstep SD replications on ssn under the
restart-to-average PDHG scheme, the compromise decision, its stratified
Monte-Carlo bound), and the small path (the instances whose K, under
128 KB, takes the small kernels: lands, a single SD run and 3
replications under the average scheme; transship and baa99-20, a single
float32 run each; a 1024-row MC panel each), and the storm path (`storm`: the reference bench's
storm_time_to_gap, SD on storm in float32 from the projected x0 = 0 and
its 8192-sample stratified MC bound, held to a band around the
literature optimum; then 30 float64 iterations and a 4096-row panel; its
float32 panels from 85 rows on the grid kernels, every float64 one on the
stream kernels (the average round's up to 256 rows); then 10
float64 iterations under the average scheme, whose SD panel is the path of
B2's stream kernel, and 10 float32 ones with a 1024-sample bound, the
path of B2's grid kernel). The main
and the replicated path also hold the tile
kernel's float32 products (FP32 FMAs in the tile kernel's order) to a
gate over whole solves: the same 4096-row panels, at the same x over
three seeds, through the tile kernel and through the row-block kernel;
the total rounds within 5 % of the row-block kernel's and every mean
within the half-width. It then runs the lands CLI against the known
optimum 381.8533. The certified path (`certify`): 8 lockstep SD
replications on ssn at the flagship settings, the compromise decision,
then the CLI's own certify tail: 8 extensive forms of CERT_FRESH (600)
fresh Latin-hypercube scenarios each (plain torch matmuls), their f64
continuation, the dual projection, the host LPs, the decision picked
among the compromise and the EF argmins on a shared panel, its bound on
an independent one; gated on every EF at tol 1e-5, dual infeasibility at
most 1e-9, each bound within 0.1 of its EF objective, and lb_cert below
the decision's ub + hw. `cli_cert` runs the lands CLI's `--replications
3 --certify`, `ef` and `--x0 crash` at once, against the known optimum
(the compromise's bound too; the EF against the exact optimum of its own
scenarios). `cert_polish` reuses the certify phase's 8 ssn states (no
extra SD): the ef_polish route (4 level-bundle rounds over the certify
phase's own fresh scenarios, CERT_FRESH per replication; each round's
recourse panels, 8 x 1 and then 8 x 2 points of every scenario, in one
solve, an R-batched projection QP, the bundle cuts merged into the EF
bound model) and the decision polish from the certify phase's compromise
decision (8192 scenarios, 4 rounds); gated on every EF at tol 1e-5, the
merged bound at least the polish's and the certify phase's EF bound of
the same streams and above the latter somewhere, lb_cert below the
decision's ub + hw, the polished decision no worse than its start and
first-stage feasible, B1's tile kernel and batched B3 launched; then B3
is held against its plain version at the projection QP's and the
decision master's own operands. `cli_gap` runs the lands CLI's
`--target-gap 0.01` (stopped at a certified gap within its 2 looks) and
the ssn CLI's periodic loop (GAP_SSN_ITERS = 40 iterations,
`--eval-every 20 --sharpen-every 20`: one sharpening, at iteration 20)
at once, each process reporting its own kernel launches; the CLI phases
start their runs together. `cli_run` runs, beside them, run management
and importance sampling through the CLI: a resumed ssn run (20 + 20
iterations) held bit for bit to an uninterrupted one (RESUME_ITERS = 40,
with a JSONL log), ssn drawn from a defensive mixture proposal under
`--profile` (the trace must name B1's cluster and B3's kernels), lands
from the uniform proposal under the reference's gates; meanwhile it
holds the native SMPS parsers to the
Python ones on ssn and storm. `mesh`, before the CLI phases, runs
multi-device SD with the ranks sharing the card over Gloo: lands in
float64 on a 2x2 mesh of 4 rank processes against one rank at 1e-8, and
ssn's flagship CLI `--mesh 2 --shard-duals` at S 4096, D 2048 through
`--coordinator`, each rank reporting its own launches; `mesh_nccl` (not
run by default: 4 cards) gives each rank a card of its own, so the
ranks join over NCCL. `surface`, before the CLI phases, drives the public
surface: every name the port's package `__init__`s re-export,
`solve_instance("lands", 20)` held bit for bit to `SDSolver.run(20)`, and
`saa_ef_bound` on two lands replications in float64 (64 fresh scenarios)
under the default dual repair, the raw duals with no host re-solve and
no f64 continuation, each bound at most its EF objective. `bench`,
after `surface` and before the CLI phases start (no other process of
the script beside it), drives the port's bench (sqlp_tpu_torch/bench.py):
`python -m sqlp_tpu_torch bench --skip-sd-gap` at the reference's depth
(ssn at B = 4096 under its HiGHS spot check, against 80 serial host
LPs), then four other sections in this process at BENCH_SMOKE's
depths (ssn_certified only in `bench_full`), each held to the
reference's keys, finite bounds and its kernels' launches; `bench_full`
(not run by default) runs the sections named by `--bench-sections` at
the reference's depths. Any failed
phase exits non-zero. The
last two lines of stdout are a JSON line of per-kernel numbers and the
JSON status line. Needs one CUDA device; exits non-zero without one.

The phase `profile` (not run by default) breaks the main and the
replicated path's time down by phase of the SD step and by kernel;
`profile_ef` (not run by default) times the certification EF's round and
reads the card's busy share under it; `polish_witness` (not run by
default, after `certify`) runs the level bundle on two of the certify
phase's states on the card and on the host's CPU through the plain
versions, on the same streams. The phase
`sweep` (not run by default) times every variant the kernels admit at the
shapes their plan functions decide between (and the float32 tile
kernel's tile heights): the thresholds of ops/cuda/pdhg_kernel.py:_plan
and ops/cuda/admm_kernel.py:_plan come from it. `digests` (not run by
default) prints the tile kernels' output digests at the fixed inputs of
_DIGEST_CASES, the record TILE_DIGESTS holds.
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
# the least time the card could take: NVIDIA's H100 SXM data-sheet peaks
# for each type, 67 TFLOP/s in float32 (CUDA cores) and 67 TFLOP/s in
# float64 (tensor cores, full IEEE FP64), and its HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(flops: float, nbytes: float, dname: str):
    """(ms, 'operations' or 'bytes'): the larger of the two lower bounds."""
    ops_ms = flops / PEAK_FLOPS[dname] * 1e3
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pdhg_bound(args, n_inner: int, dname: str):
    """Bound of one PDHG round: its two products (2 m n FMAs per row and
    step), each operand read once and the four [B, *] outputs written
    once."""
    m, n = args[0].shape
    B = args[5].shape[0]
    flops = 4.0 * m * n * B * n_inner
    out = 2 * B * (m + n) * 2 * args[0].element_size()
    return bound_ms(flops, _nbytes(args) + out, dname)


def admm_bound(ops, n_inner: int, dname: str):
    """Bound of one ADMM interval: As^T w and As x (2 mA nz FMAs) and the
    three nz x nz products per step, each operand read once and z, zeta,
    mu written once."""
    mA, nz = ops[0].shape[-2:]
    nb = ops[0].shape[0] if ops[0].dim() == 3 else 1
    flops = 2.0 * (2 * mA * nz + 3 * nz * nz) * n_inner * nb
    return bound_ms(flops, _nbytes(ops) + _nbytes(ops[7:]), dname)


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
    """Milliseconds per call, CUDA events around reps calls: the time a
    caller pays per call, the host's wrapper work included wherever it
    outlasts the device's."""
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


def device_ms(fn, reps: int) -> float:
    """Milliseconds per launch on the card alone: the reps launches are
    queued behind a device-side sleep that outlasts their enqueueing, so
    the CUDA events see the kernels back to back and none of the host's
    wrapper work."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # at most about 2 GHz: 2e9 cycles a second cover twice the host time
    torch.cuda._sleep(int((2.0 * host_s + 1e-3) * 2e9))
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


# phase -> the scheme whose round it checks; scheme -> operands its
# wrapper takes of the 13 that _pdhg_case builds (the average round has no
# step count and no anchors)
_PDHG_PHASES = {"b1": "halpern", "b2": "average"}
_PDHG_ARGS = {"halpern": 13, "average": 10}
# the paths' rungs (the SD panels of 2 and 16 rows, the MC ladder 4096,
# 1024, 768, 512, 256), storm's (the storm path's SD panel of 2 rows and
# its ladder 4096, 1024, 256; 16 and a ragged tile of 100; a ragged 1000
# with per-element q, a ragged last part and tile of the grid kernel),
# lands and per-element q (a ragged tile too); (lands, 2) is the mesh
# phase's SD panel in f64; transship's and baa99-20's SD panel, the
# replications' 16 rows and the MC panels of 1024 and 4096 rows, and
# baa99-20 at a ragged 1000 rows with per-element q (the small kernels'
# ragged last group)
_PDHG_CASES = (("lands", 8, False), ("lands", 2, False),
               ("transship", 2, False), ("transship", 16, False),
               ("transship", 1024, False), ("transship", 4096, False),
               ("baa99-20", 2, False), ("baa99-20", 16, False),
               ("baa99-20", 1024, False), ("baa99-20", 4096, False),
               ("baa99-20", 1000, True),
               ("ssn", 2, False), ("ssn", 16, False),
               ("ssn", 256, False), ("ssn", 512, False),
               ("ssn", 768, False), ("ssn", 1024, False),
               ("ssn", 4096, False),
               ("storm", 2, False), ("storm", 16, False),
               ("storm", 100, False), ("storm", 256, False),
               ("storm", 1024, False), ("storm", 4096, False),
               ("storm", 1000, True),
               ("ssn", 2, True), ("ssn", 100, True))
# the polish routes' float32 panels, Halpern only: the decision polish's
# 8192 rows, the level bundle's 8 x CERT_FRESH (round 1) and 8 x 2 x
# CERT_FRESH (later rounds) at CERT_FRESH = 1000 (its value before the
# small kernels' cases needed the script's time)
# and the 16384 of its 8 x 2 x 1024
_POLISH_CASES = (("ssn", 8000, False), ("ssn", 8192, False),
                 ("ssn", 16000, False), ("ssn", 16384, False))
# the bench's float32 panels, Halpern only, in the plan's variant:
# storm_certified's evaluate_ci(batch=8192) panel
# (sqlp_tpu_torch/bench.py:_bench_certified)
_BENCH_CASES = (("storm", 8192, False),)
# a variant's entry in the kernels line: the wrapper's counter and the
# shape and dtype its time is reported at (the path's own: the SD panel of
# the main path is 2 rows, of the replicated path 16, the MC panel 4096;
# the small kernels keep lands on the small path (the row-block kernels,
# their oracle, are reported at the same shape); the stream kernels
# storm's float64 panels, 256 rows of the Halpern legs and the average
# leg's SD panel of 2; the grid kernels storm's 4096-row float32 rung)
_PDHG_ENTRY = {
    ("halpern", "rows"): ("pdhg_halpern_round", "lands", 8, "float32"),
    ("halpern", "cluster"): ("pdhg_halpern_cluster", "ssn", 2, "float32"),
    ("halpern", "tile"): ("pdhg_halpern_tile", "ssn", 4096, "float32"),
    ("halpern", "stream"): ("pdhg_halpern_stream", "storm", 256, "float64"),
    ("halpern", "grid"): ("pdhg_halpern_grid", "storm", 4096, "float32"),
    ("halpern", "small"): ("pdhg_halpern_small", "lands", 8, "float32"),
    ("average", "rows"): ("pdhg_average_round", "lands", 8, "float32"),
    ("average", "cluster"): ("pdhg_average_cluster", "ssn", 16, "float32"),
    ("average", "tile"): ("pdhg_average_tile", "ssn", 4096, "float32"),
    ("average", "stream"): ("pdhg_average_stream", "storm", 2, "float64"),
    ("average", "grid"): ("pdhg_average_grid", "storm", 4096, "float32"),
    ("average", "small"): ("pdhg_average_small", "lands", 8, "float32"),
}
# the variants admitted only while they are the row-block round's bits,
# and the dtypes each is admitted for (the stream and grid kernels are
# held to those bits in float32, the small kernels in both dtypes)
_ROWBLOCK_BITS = {"stream": "_STREAM_ITEMSIZES", "grid": "_GRID_ITEMSIZES",
                  "small": "_SMALL_ITEMSIZES"}
_ROWBLOCK_BITS_F64 = ("small",)


def _variants(args, scheme):
    """A round's variants to check at these operands: the plan's first,
    then the row-block kernel and the cluster, tile, stream, grid and
    small kernels wherever they take the shape (the grid kernel: float32
    panels of a K that no tile shape takes; the small kernel: a K under
    the cluster kernels' threshold)."""
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    m, n = args[0].shape
    B = args[5].shape[0]
    it = args[0].element_size()
    out = [pk._plan(B, m, n, it, scheme)]
    rows = ("rows", pk._rows_per_block(
        f"pdhg_{scheme}_round", B, pk._row_values(m, n, scheme) * it))
    shape = pk._cluster_shape(B, m, n, it, scheme)
    tile = pk._tile_shape(B, m, n, it, scheme)
    stream = pk._stream_shape(B, m, n, it, scheme) if tile is None else None
    grid = pk._grid_shape(B, m, n, it) if tile is None \
        and m * n * it >= pk._CLUSTER_MIN_K_BYTES else None
    small = pk._small_shape(B, m, n, it) \
        if m * n * it < pk._CLUSTER_MIN_K_BYTES else None
    for alt in (rows, ("cluster",) + shape if shape else None,
                ("tile",) + tile if tile else None,
                ("stream",) + stream if stream else None,
                ("grid",) + grid if grid else None,
                ("small",) + small if small else None):
        if alt is not None and alt not in out:
            out.append(alt)
    return out


def phase_pdhg(results, phase):
    """One PDHG round against its plain version, f32 and f64, at the
    shapes of the SD step (B = 2; 16 replicated), the MC panel (B = 4096),
    storm, lands and per-element q (a ragged tile too), and the Halpern
    round in f32 at the polish routes' panels (8000 to 16,384 rows) and
    the bench's storm panel of 8192 rows (only the plan's variant and
    the row-block kernel there): every
    variant the shape admits, timed in the same call, two launches bitwise
    equal. The float32 stream and grid variants and the small variant in
    both dtypes are also held to the row-block kernel's bits: where the
    plan admits them (rule (a) of their admission,
    pdhg_kernel._STREAM_ITEMSIZES, _GRID_ITEMSIZES and _SMALL_ITEMSIZES),
    a difference fails the phase. Last, the scheme's tile kernel against
    TILE_DIGESTS, bit for bit."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    scheme = _PDHG_PHASES[phase]
    name, n_args = f"pdhg_{scheme}_round", _PDHG_ARGS[scheme]
    kernel = getattr(pk, name)
    plain = getattr(pk, name + "_ref")
    n_inner = 80
    worst = {}
    cases = [(c, (torch.float32, torch.float64)) for c in _PDHG_CASES]
    if scheme == "halpern":
        cases += [(c, (torch.float32,))
                  for c in _POLISH_CASES + _BENCH_CASES]
    for (inst, B, per_el), dtypes in cases:
        for dtype in dtypes:
            args = _pdhg_case(inst, B, dtype, per_el_q=per_el)[:n_args]
            dname = str(dtype).replace("torch.", "")
            # storm's rounds take milliseconds even at a few rows
            reps = 3 if B >= 1024 or inst == "storm" else 20
            ref = plain(*args, n_inner)
            torch.cuda.synchronize()
            plain_ms = time_ms(lambda: plain(*args, n_inner), reps)
            bound = pdhg_bound(args, n_inner, dname)
            variants = _variants(args, scheme)
            if (inst, B, per_el) in _BENCH_CASES:
                # the plan's variant, and the row-block kernel it is held
                # to bit for bit
                variants = [v for v in variants
                            if v[0] in (variants[0][0], "rows")]
            took = {}       # ms by variant: "rows", "cluster", "tile", ...
            for plan in variants:
                out = kernel(*args, n_inner, plan=plan)
                torch.cuda.synchronize()
                abs_err = max(float((o - r).abs().max())
                              for o, r in zip(out, ref))
                ok, err = agree(out, ref, dname)
                again = kernel(*args, n_inner, plan=plan)
                torch.cuda.synchronize()
                same = all(torch.equal(a, o) for a, o in zip(again, out))
                bits = ""
                if plan[0] in _ROWBLOCK_BITS and (
                        dname == "float32" or plan[0] in _ROWBLOCK_BITS_F64):
                    rows = kernel(*args, n_inner, plan=variants[[
                        v[0] for v in variants].index("rows")])
                    torch.cuda.synchronize()
                    bitwise = all(torch.equal(a, o)
                                  for a, o in zip(rows, out))
                    bits = f"bitwise_vs_rows={bitwise} "
                    if not bitwise and args[0].element_size() in getattr(
                            pk, _ROWBLOCK_BITS[plan[0]]):
                        raise AssertionError(
                            f"{name} {plan} is admitted on {dname} panels "
                            f"as the row-block round's bits, but differs "
                            f"from them on {inst} B={B}")
                ms = device_ms(lambda: kernel(*args, n_inner, plan=plan),
                               reps)
                call = time_ms(lambda: kernel(*args, n_inner, plan=plan),
                               reps)
                waves = ""
                if plan[0] == "small":
                    groups = pk._small_groups(B, *plan[1:], *args[0].shape,
                                              args[0].element_size())
                    waves = f"groups={groups} "
                if plan[0] == "tile":
                    it = args[0].element_size()
                    occ = pk._tile_clusters_per_wave(
                        plan[1], *args[0].shape, it, scheme)
                    passes = pk._tile_passes(B, plan[1], *args[0].shape, it,
                                             scheme)
                    tm = pk._tile_rows(B, plan[1], *args[0].shape, it,
                                       scheme)
                    before = _FIRST_TILE_MS.get((scheme, inst, B, dname)) \
                        if not per_el else None
                    waves = (f"clusters_per_wave={occ} passes={passes} "
                             f"tm={tm} first_kernel_ms="
                             f"{'n/a' if before is None else before} ")
                log(f"[{phase}] {inst} B={B} "
                    f"q={'per-el' if per_el else 'shared'} {dname} "
                    f"{plan[0]}{plan[1:]}: {waves}"
                    f"max_rel_err={err:.3e} (tol {TOL[dname]:g}) "
                    f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
                    f"call_ms={call:.4f} plain_ms={plain_ms:.4f} "
                    f"bound_ms={bound[0]:.6f} deterministic={same} {bits}"
                    f"{'ok' if ok and same else 'FAIL'}")
                if not (ok and same):
                    raise AssertionError(f"{name} {plan} disagrees with its "
                                         f"plain version on {inst} B={B} "
                                         f"{dname}")
                key, *at = _PDHG_ENTRY[scheme, plan[0]]
                worst[key] = max(worst.get(key, 0.0), abs_err)
                took[plan[0]] = ms
                if not per_el and [inst, B, dname] == at:
                    results[key].update(
                        ms=ms, call_ms=call, plain_ms=plain_ms,
                        plan=list(plan),
                        shape=f"{inst} B={B} f{8 * args[0].element_size()}")
                    _set_bound(results[key], bound)
            for kind in took:
                key, *at = _PDHG_ENTRY[scheme, kind]
                if kind != "rows" and not per_el \
                        and [inst, B, dname] == at:
                    # the row-block kernel's time at the shape the entry
                    # reports
                    results[key]["rowblock_ms"] = took["rows"]
    for key, v in worst.items():
        results[key]["max_abs_err"] = v
    _hold_tile_digests(phase)


# the first tile design's times at the rungs it took, device ms per
# 80-step round (PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W), printed
# beside this tree's
_FIRST_TILE_MS = {
    ("halpern", "ssn", 4096, "float32"): 15.383,
    ("halpern", "ssn", 1024, "float32"): 5.122,
    ("halpern", "ssn", 768, "float32"): 3.417,
    ("halpern", "ssn", 512, "float32"): 3.413,
    ("halpern", "ssn", 256, "float32"): 1.713,
    ("halpern", "ssn", 8192, "float32"): 30.66,
    ("halpern", "ssn", 16384, "float32"): 59.64,
    ("halpern", "ssn", 256, "float64"): 1.417,
    ("average", "ssn", 4096, "float32"): 15.477,
    ("average", "ssn", 1024, "float32"): 5.159,
    ("average", "ssn", 768, "float32"): 3.447,
    ("average", "ssn", 512, "float32"): 3.439,
    ("average", "ssn", 256, "float32"): 1.730}

# The tile kernels' outputs at fixed inputs, bit for bit: (scheme,
# instance, B, dtype, per-element q, cluster size) of every tile shape the
# paths give the kernels (ssn's ladder and the polish panels at the plan's
# C; the float64 rung; a ragged last tile; a single row; per-element q;
# lands forced onto other cluster sizes)
_DIGEST_CASES = (
    *(("halpern", "ssn", B, "float32", False, 4)
      for B in (1, 256, 512, 700, 768, 1024, 4096, 8000, 8192, 16000,
                16384)),
    *(("average", "ssn", B, "float32", False, 4)
      for B in (256, 512, 700, 768, 1024, 4096)),
    *((s, "ssn", 100, "float32", True, 4) for s in ("halpern", "average")),
    *((s, "ssn", B, "float64", False, 8) for s in ("halpern", "average")
      for B in (256, 700)),
    *(("halpern", "lands", 40, "float32", False, C) for C in (4, 8, 16)),
    *(("average", "lands", 40, "float32", False, C) for C in (8, 16)),
    ("halpern", "lands", 40, "float64", False, 8))
# the first 16 hex digits of the SHA-256 of each output's bytes (Yout,
# Lout, Yout2, Lout2) and of all the inputs', by _digest_key of the case:
# the first tile design (commit 2fce5b6), run on an NVIDIA H100 80GB HBM3
# at 700 W by `chip_smoke.py --phases device,digests`
TILE_DIGESTS = {
    "halpern ssn B=1 float32 q=shared C=4": [
        "2d4495cebda6d10e", "249dd5d5a10cd6bd", "3071cda093851461",
        "cbda4480f8074df7", "a82d9730fc2abf3c"],
    "halpern ssn B=256 float32 q=shared C=4": [
        "9dd4ac650d5799d8", "6c3fd205ce22add4", "67b412b974d0482f",
        "ebf2bac792092645", "093b2a8ae08fe71b"],
    "halpern ssn B=512 float32 q=shared C=4": [
        "f561988e59b27d0e", "3544700d00c6e727", "99651f1e34338e8d",
        "6b9ccdff846e17b8", "d9639b0b7aa6c2e0"],
    "halpern ssn B=700 float32 q=shared C=4": [
        "1ab338ff399bc1f0", "e995b7a283a2c48c", "b4ce5182aa71c1fb",
        "a0ed400d5c56c3d2", "2bf71c606eed1737"],
    "halpern ssn B=768 float32 q=shared C=4": [
        "4920d0a117289406", "2db20b601ad14e93", "e5c4131c21956ab0",
        "c77e5862e2a13273", "a0fcc1a48c5b714b"],
    "halpern ssn B=1024 float32 q=shared C=4": [
        "1260ac4355676db1", "1cc2e22cf92eaa1f", "edb2f493bf0709d6",
        "0c1d2726bb1a7eda", "3ee30d304136cbdb"],
    "halpern ssn B=4096 float32 q=shared C=4": [
        "d4c4d11d956b1f05", "497200550ea0e722", "d9384a4d32137c00",
        "606966316b86ebd8", "16b7e937d3c06624"],
    "halpern ssn B=8000 float32 q=shared C=4": [
        "073dc19ddab6cb34", "c494a305329e4c53", "4c6603a0c5be50a7",
        "2ed50f03487f2cf5", "4ac64222f9e99520"],
    "halpern ssn B=8192 float32 q=shared C=4": [
        "0389ecd71a8d1f7b", "2361700076ca88c7", "70dfb518dd5f2422",
        "808d0d9b1ced9239", "8d900d9d78cc0165"],
    "halpern ssn B=16000 float32 q=shared C=4": [
        "77f61aed685793d7", "b1e00d3693cb0484", "85aecf2b195702d8",
        "1086562d30dbd996", "dbe039df30889987"],
    "halpern ssn B=16384 float32 q=shared C=4": [
        "0bbbead63e2ef529", "7423954dd490ea2f", "b7eba63095f3925f",
        "e25c54254c254171", "cfae0f4e9dd79942"],
    "halpern ssn B=100 float32 q=per-el C=4": [
        "94a7f6ad90c1bc98", "a586d2faf3e0e33b", "c896903958ecc305",
        "4bc85bfcc2533f70", "95b79070967bf3cb"],
    "halpern ssn B=256 float64 q=shared C=8": [
        "8bd4345ae0c35ef4", "3ebb6f0c5eca5ebe", "fe492b241a1bdfbf",
        "302b09b4a4b51063", "9b8b97cea38d32b4"],
    "halpern ssn B=700 float64 q=shared C=8": [
        "c76804c365f8e53d", "fa8248f24a4d42f5", "3c8f7c85fa25673c",
        "eeb39adedc3205eb", "3473a1f315acf5f6"],
    "halpern lands B=40 float32 q=shared C=4": [
        "1cefcbc753f5c99d", "d9707c46b8ba3229", "866de968b67147f0",
        "a3f02c3ba6e8d017", "6f71522f6a931014"],
    "halpern lands B=40 float32 q=shared C=8": [
        "8579dfc5652ce338", "00c6295d2874ef9c", "051c76d66ba5c79e",
        "0a3bd9d50e4fca42", "6f71522f6a931014"],
    "halpern lands B=40 float32 q=shared C=16": [
        "3995e9f87f2fa439", "24b8a1744b956467", "c8b3cd88a13fbb82",
        "1a8596592a68c1d1", "6f71522f6a931014"],
    "halpern lands B=40 float64 q=shared C=8": [
        "80cc001fafc85ea0", "83b5d055a4c273d3", "2ba169496ea4e4a8",
        "ccfc4ced5ebe207c", "81fb30223759c809"],
    "average ssn B=256 float32 q=shared C=4": [
        "bf3b4199ffeaa531", "f5ff4bcd552be7fa", "b11f93a3c807630b",
        "aba25e340a8f8121", "5a9ccd807386cdf0"],
    "average ssn B=512 float32 q=shared C=4": [
        "820fe368f88b1a82", "0e2cc94fea3da761", "f4fda71e41aa156a",
        "289fa30f45d8bbae", "94d036fbf13e0b26"],
    "average ssn B=700 float32 q=shared C=4": [
        "4181c29deb22df9f", "8528b3c47de2c105", "207c8897607c9898",
        "6688cdab1e8f5893", "064586a7c4f325ea"],
    "average ssn B=768 float32 q=shared C=4": [
        "24a5960438ef1bef", "7ac3f97e0bb17110", "00be4ec651a29d64",
        "cb0cfa4b59edd7f9", "c2ef7f153719043b"],
    "average ssn B=1024 float32 q=shared C=4": [
        "f0ae54c94e619b18", "2864bd0978e9d4a2", "41fbc90147f162cd",
        "eb4a970615e92fee", "7a530c2d4bb4b137"],
    "average ssn B=4096 float32 q=shared C=4": [
        "8d64939714bf26da", "3190d17a06b76f67", "d4d1778009bb1ddd",
        "a79d18cc602dcbc5", "3841068a1d67e95d"],
    "average ssn B=100 float32 q=per-el C=4": [
        "40244a566fb64f07", "6c73b1900e75a2a1", "86117ae17b047fb2",
        "266403796ca7f281", "26cc5c84fc001150"],
    "average ssn B=256 float64 q=shared C=8": [
        "e888f7b39fb93ff6", "57e38c268709f8dc", "53180db2cc23cad5",
        "8ad88f1356c49d3d", "e8b7b3a401a8b602"],
    "average ssn B=700 float64 q=shared C=8": [
        "56bc2b748a578bc9", "96a5a00b0e29b5db", "d6504b4cfdc163a7",
        "42419724a9467a34", "08fe76c694238627"],
    "average lands B=40 float32 q=shared C=8": [
        "a134f5a5b126803c", "da720afb57da62eb", "f5886809ccbc06b3",
        "d60b17d1e7e91916", "6e5955c3936f5952"],
    "average lands B=40 float32 q=shared C=16": [
        "a134f5a5b126803c", "da720afb57da62eb", "f5886809ccbc06b3",
        "d60b17d1e7e91916", "6e5955c3936f5952"],
}


def _digest_key(scheme, inst, B, dname, per_el, C):
    return (f"{scheme} {inst} B={B} {dname} "
            f"q={'per-el' if per_el else 'shared'} C={C}")


def _digest_inputs(inst, B, dname, per_el, seed=0):
    """A Halpern round's 13 operands on the card, the same bits on every
    host: the instance's prepared recourse LP (built on the CPU in float64)
    with K and q on a grid of 2^-16, power-of-two steps under 0.7 / ||K||
    (scaled per row by 1 + k / 16), and iterates, anchors, right-hand side
    and step counts from numpy's generator on grids of powers of two."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.ops.pdhg import prepare_lp

    a = load_instance(inst, dtype=torch.float64, device="cpu").arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    rng = np.random.default_rng(seed)

    def grid(x, bits):
        return np.round(np.asarray(x, dtype=np.float64) * 2.0 ** bits) \
            / 2.0 ** bits
    K = grid(lp.K.numpy(), 16)
    m, n = K.shape
    q = grid(lp.q.numpy(), 16)
    if per_el:
        q = q[None, :] * (1.0 + rng.integers(0, 8, (B, n)) / 64.0)
    lb = np.where(np.isfinite(lp.lb.numpy()), grid(lp.lb.numpy(), 16), -1e30)
    ub = np.where(np.isfinite(lp.ub.numpy()), grid(lp.ub.numpy(), 16), 1e30)
    step = 2.0 ** math.floor(math.log2(0.7 / np.linalg.norm(K, 2)))
    tau = step * (1.0 + rng.integers(0, 4, B) / 16.0)
    sig = step * (1.0 + rng.integers(0, 4, B) / 16.0)
    ht = grid(rng.normal(0.0, 1.0, (B, m)), 10)
    Y = np.clip(grid(rng.uniform(0.0, 1.0, (B, n)), 10), lb, ub)
    L = grid(rng.normal(0.0, 0.5, (B, m)), 10)
    kh = rng.integers(0, 200, B).astype(np.float64)
    Yanc = np.clip(Y + grid(rng.normal(0.0, 0.1, (B, n)), 10), lb, ub)
    Lanc = L + grid(rng.normal(0.0, 0.1, (B, m)), 10)
    dt = getattr(torch, dname)
    dev = torch.device("cuda")

    def t(x, dtype=dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtype).contiguous()
    return (t(K), t(q), t(lb), t(ub), t(lp.is_eq.numpy(), torch.bool),
            t(ht), t(tau), t(sig), t(Y), t(L), t(kh), t(Yanc), t(Lanc))


def _sha(tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def tile_digests(scheme):
    """{case key: [digest of Yout, Lout, Yout2, Lout2, inputs]} of the
    scheme's tile kernel at every case of _DIGEST_CASES."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    out = {}
    for case in _DIGEST_CASES:
        if case[0] != scheme:
            continue
        _, inst, B, dname, per_el, C = case
        args = _digest_inputs(inst, B, dname, per_el)[:_PDHG_ARGS[scheme]]
        kernel = getattr(pk, f"pdhg_{scheme}_round")
        it = args[0].element_size()
        res = kernel(*args, 80, plan=("tile", C, pk._TILE_ARITH[it]))
        torch.cuda.synchronize()
        out[_digest_key(*case)] = [_sha([r]) for r in res] + [_sha(args)]
    return out


def _hold_tile_digests(phase):
    """The scheme's tile kernel against TILE_DIGESTS, output by output,
    bit for bit; raises on any difference (an input digest that differs
    says the inputs moved, not the kernel)."""
    scheme = _PDHG_PHASES[phase]
    got = tile_digests(scheme)
    bad = []
    for key, digests in got.items():
        want = TILE_DIGESTS.get(key)
        same = want is not None and want == digests
        log(f"[{phase}] digest {key}: {'bitwise' if same else 'DIFFERS'}"
            f"{'' if same else f' (got {digests}, want {want})'}")
        if not same:
            bad.append(key)
    if bad:
        raise AssertionError(f"pdhg_{scheme}_tile differs from its recorded "
                             f"bits at {bad}")


def phase_digests():
    """Print TILE_DIGESTS for the kernels of this tree, both schemes."""
    got = {}
    for scheme in ("halpern", "average"):
        got.update(tile_digests(scheme))
    log("[digests] " + json.dumps(got))


def _set_bound(entry, bound):
    entry["bound_ms"], entry["bound_by"] = bound


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


def _b3_cases(names=("ssn", "storm")):
    """(name, float64 operands) of the named instances' masters of a real
    SD state, advanced 100 plain ADMM steps so an interval starts
    mid-solve."""
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    from sqlp_tpu_torch.ops.prox_qp import admm_operands

    for name in names:
        (p_diag, g, A, l, u, is_eq), qp = _master_after_steps(name, 3)
        ops64 = list(admm_operands(p_diag, g, A, l, u, is_eq, qp, qp.rho))
        ops64[7:] = ak.admm_round_ref(*ops64, 100, qp.over_relax, qp.sigma)
        yield name, [t.contiguous() for t in ops64], qp


def _batch_of(ops, nb):
    """nb distinct masters: the linear term and the start scaled per QP."""
    import torch
    scale = 1.0 + 0.05 * torch.arange(nb, dtype=ops[0].dtype,
                                      device=ops[0].device)
    out = []
    for i, t in enumerate(ops):
        tb = torch.stack([t] * nb)
        if i in (3, 7):     # g, z
            tb = tb * scale[:, None]
        out.append(tb.contiguous())
    return out


def _admm_plain(ops, n_inner, alpha, sigma):
    """The plain version, one QP at a time over a leading batch axis."""
    import torch
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    if ops[0].dim() == 2:
        return ak.admm_round_ref(*ops, n_inner, alpha, sigma)
    outs = [ak.admm_round_ref(*(t[b] for t in ops), n_inner, alpha, sigma)
            for b in range(ops[0].shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def _hold_b3(tag, label, ops, args, sizes=None):
    """B3 at these operands (a leading batch axis or none) against its
    plain version, at each cluster size in ``sizes`` (default: the plan's
    own): within TOL and two launches bitwise equal, else it raises.
    Returns, per size, (C, kernel ms, call ms, plain ms, max abs error,
    (bound ms, bound by))."""
    import torch
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak

    dname = str(ops[0].dtype).replace("torch.", "")
    mA, nz = ops[0].shape[-2:]
    nb = ops[0].shape[0] if ops[0].dim() == 3 else 1
    ref = _admm_plain(ops, *args)
    torch.cuda.synchronize()
    plain_ms = time_ms(lambda: _admm_plain(ops, *args), 20)
    bound = admm_bound(ops, args[0], dname)
    it = ops[0].element_size()
    out_rows = []
    for C in sizes or [ak._plan(mA, nz, it)]:
        out = ak.admm_round(*ops, *args, plan=C)
        torch.cuda.synchronize()
        abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        ok, err = agree(out, ref, dname)
        again = ak.admm_round(*ops, *args, plan=C)
        torch.cuda.synchronize()
        same = all(torch.equal(a, o) for a, o in zip(again, out))
        ms = device_ms(lambda: ak.admm_round(*ops, *args, plan=C), 50)
        call = time_ms(lambda: ak.admm_round(*ops, *args, plan=C), 50)
        log(f"{tag} {label} x{nb} nz={nz} mA={mA} {dname} cluster={C}: "
            f"max_rel_err={err:.3e} (tol {TOL[dname]:g}) "
            f"max_abs_err={abs_err:.3e} kernel_ms={ms:.4f} "
            f"call_ms={call:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound[0]:.6f} deterministic={same} "
            f"{'ok' if ok and same else 'FAIL'}")
        if not (ok and same):
            raise AssertionError(f"admm_round (cluster {C}) disagrees with "
                                 f"its plain version on {label} x{nb} "
                                 f"{dname}")
        out_rows.append((C, ms, call, plain_ms, abs_err, bound))
    return out_rows


def phase_b3(results, plans=None):
    """B3 against its plain version for the ssn and storm masters in f32
    and f64, unbatched and as a batch of 8; ``plans`` (the sweep) times
    every cluster size that fits instead of the plan's alone, and lands'
    small master too."""
    import torch
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak

    worst = 0.0
    names = ("ssn", "storm") if plans is None else ("lands", "ssn", "storm")
    for name, ops64, qp in _b3_cases(names):
        args = (qp.check_every, qp.over_relax, qp.sigma)
        for dtype, nb in ((torch.float32, 1), (torch.float64, 1),
                          (torch.float64, 8)):
            ops = [t.to(dtype).contiguous() for t in ops64]
            if nb > 1:
                ops = _batch_of(ops, nb)
            mA, nz = ops[0].shape[-2:]
            it = ops[0].element_size()
            sizes = None if plans is None else [
                C for C in (1, 2, 4, 8)
                if ak._smem_bytes(C, mA, nz, it) <= ak._SMEM_MAX]
            for C, ms, call, plain_ms, abs_err, bound in _hold_b3(
                    "[b3]", f"{name} master", ops, args, sizes):
                worst = max(worst, abs_err)
                if plans is None and name == "ssn" and nb == 1 \
                        and dtype == torch.float64:
                    results["admm_round"].update(
                        ms=ms, call_ms=call, plain_ms=plain_ms, cluster=C,
                        shape="ssn master f64")
                    _set_bound(results["admm_round"], bound)
    results["admm_round"]["max_abs_err"] = worst


def _sweep_round(scheme, inst, B, dtype):
    """Every variant a round admits at one shape, timed and held against
    the plain version; the plan's own choice is marked."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    name, n_args = f"pdhg_{scheme}_round", _PDHG_ARGS[scheme]
    kernel = getattr(pk, name)
    n_inner = 80
    args = _pdhg_case(inst, B, dtype)[:n_args]
    m, n = args[0].shape
    it = args[0].element_size()
    dname = str(dtype).replace("torch.", "")
    plans = [("rows", pk._rows_per_block(
        f"pdhg_{scheme}_round", B, pk._row_values(m, n, scheme) * it))]
    if m * n * it < pk._CLUSTER_MIN_K_BYTES:
        # the small kernel's group widths (up to 4 times the plan's) and
        # rows a group
        own = pk._small_shape(B, m, n, it)
        plans += [("small", W, R) for W in pk._SMALL_WARPS
                  for R in pk._SMALL_ROWS
                  if own and W <= 4 * own[0] and R <= B
                  and pk._small_fits(W, R, 1, m, n, it)]
    elif B <= 1024:     # past that a cluster per few rows takes seconds
        plans += [("cluster", C, R) for C in pk._CLUSTER_SIZES
                  for R in pk._CLUSTER_ROWS
                  if R <= B and pk._cluster_fits(C, R, m, n, it, scheme)]
    big = m * n * it >= pk._CLUSTER_MIN_K_BYTES
    plans += [("tile", C, pk._TILE_ARITH[it]) for C in pk._CLUSTER_SIZES
              if big and pk._tile_fits(C, m, n, it, pk._TILE_ARITH[it])]
    tile = pk._tile_shape(B, m, n, it, scheme) if big else None
    if tile is not None and it == 4:
        # the float32 tile height at the plan's cluster size
        own = pk._tile_rows(B, tile[0], m, n, it, scheme)
        plans += [("tile",) + tile + (tm,) for tm in (16, 12, 8, 4, 2)
                  if tm != own and tm <= -(-B // 2)]
    plans += [("stream", C, pk._STREAM_TM) for C in pk._STREAM_SIZES
              if big and pk._stream_fits(C, pk._STREAM_TM, m, n, it)]
    if tile is None and big:
        # primal tile heights, the panel in 1, 2 and 4 parts
        plans += [("grid", BM, P) for BM in pk._GRID_BM for P in (1, 2, 4)
                  if pk._grid_fits(BM, it, P) and (P - 1) * 128 < B]
    chosen = pk._plan(B, m, n, it, scheme)
    ref = getattr(pk, name + "_ref")(*args, n_inner)
    reps = 3 if B >= 1024 else 10
    for plan in plans:
        if plan[0] == "cluster":
            occ = pk._clusters_per_wave(*plan[1:], m, n, it, scheme)
        elif plan[0] == "tile":
            occ = pk._tile_clusters_per_wave(plan[1], m, n, it, scheme)
        elif plan[0] == "stream":
            occ = pk._stream_clusters_per_wave(plan[1], m, n, it, scheme)
        elif plan[0] == "small":
            occ = pk._small_groups(B, *plan[1:], m, n, it)
        else:
            occ = None
        tag = f"[sweep] {scheme} {inst} B={B} {dname} {plan}"
        if occ == 0:
            log(f"{tag}: the card cannot schedule it "
                f"(max_active_clusters=0)")
            continue
        out = kernel(*args, n_inner, plan=plan)
        torch.cuda.synchronize()
        ok, err = agree(out, ref, dname)
        ms = device_ms(lambda: kernel(*args, n_inner, plan=plan), reps)
        passes = pk._tile_passes(B, plan[1], m, n, it, scheme) \
            if plan[0] == "tile" else None
        if plan[0] == "tile":       # tiles of tm rows in turn
            tm = plan[3] if len(plan) == 4 else pk._tile_rows(
                B, plan[1], m, n, it, scheme)
            passes = f"{-(-(-(-B // tm)) // occ)} tm={tm}"
        if plan[0] == "stream":     # waves of one tile per cluster
            passes = -(-(-(-B // pk._STREAM_TM)) // occ)
        occ_tag = "groups" if plan[0] == "small" else "max_active_clusters"
        log(f"{tag}: kernel_ms={ms:.4f} max_rel_err={err:.2e} "
            f"{occ_tag}={occ} passes={passes}"
            f"{' <- plan' if plan == chosen else ''} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {plan} disagrees with its plain "
                                 f"version on {inst} B={B} {dname}")


# the sweep's instances of a K under 128 KB and their panels: the SD
# step's 2 rows, lands' 8, the replications' 16, the ladder's 256, 1024
# and 4096
SWEEP_SMALL = ("lands", "transship", "baa99-20")
SWEEP_SMALL_SIZES = (2, 8, 16, 256, 1024, 4096)


def phase_sweep(instances):
    """Every variant the kernels admit, timed at the shapes their plans
    decide between (one call, one card): both PDHG rounds' row-block
    kernels against their cluster kernels (cluster sizes, rows per
    cluster), tile kernels (cluster sizes) and, for storm, stream kernels
    (cluster sizes) and, in float32, grid kernels (primal tile heights,
    parts); for a K under 128 KB against the small kernels (group widths,
    rows a group); and B3 over cluster sizes. ``instances`` names the
    instances to sweep (ssn and storm also run the fixed-cost lines and
    B3)."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    f32, f64 = torch.float32, torch.float64
    for inst in SWEEP_SMALL:
        if inst not in instances:
            continue
        for scheme in ("halpern", "average"):
            for dtype in (f32, f64):
                for B in SWEEP_SMALL_SIZES:
                    _sweep_round(scheme, inst, B, dtype)
    for scheme, inst, sizes, dtypes in (
            ("halpern", "ssn", (2, 16, 64, 256, 512, 768, 1024, 4096),
             (f32, f64)),
            ("average", "ssn", (16, 64, 256, 512, 768, 1024, 4096),
             (f32, f64)),
            ("halpern", "storm", (2, 16, 64, 100, 256, 1024, 4096),
             (f32, f64)),
            ("average", "storm", (2, 16, 64, 100, 256, 1024, 4096),
             (f32, f64))):
        for dtype in dtypes:
            for B in sizes:
                if inst in instances:
                    _sweep_round(scheme, inst, B, dtype)
    n_inner = 80
    if "ssn" in instances or "storm" in instances:
        phase_b3({"admm_round": {}}, plans="all")
    # each planned kernel's fixed cost (launch, loading its matrices) and
    # its cost per step, from device times at 1 step and at a full round
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    for scheme, inst, B, dtype in (("halpern", "ssn", 2, f32),
                                   ("halpern", "ssn", 2, f64),
                                   ("average", "ssn", 16, f32),
                                   ("halpern", "ssn", 4096, f32),
                                   ("halpern", "ssn", 4096, f64),
                                   ("halpern", "lands", 2, f32),
                                   ("halpern", "lands", 2, f64),
                                   ("halpern", "baa99-20", 4096, f32)):
        if inst not in instances:
            continue
        n_args = _PDHG_ARGS[scheme]
        kernel = getattr(pk, f"pdhg_{scheme}_round")
        args = _pdhg_case(inst, B, dtype)[:n_args]
        plan = pk._plan(B, *args[0].shape, args[0].element_size(), scheme)
        t1, t80 = (device_ms(lambda: kernel(*args, k, plan=plan), 5)
                   for k in (1, n_inner))
        log(f"[sweep] {scheme} {inst} B={B} {dtype} {plan}: 1 step {t1:.4f} "
            f"ms, 80 steps {t80:.4f} ms: {1e3 * (t80 - t1) / 79:.2f} us "
            f"per step, {1e3 * (t1 - (t80 - t1) / 79):.1f} us fixed")
    for name, ops64, qp in _b3_cases():
        if name not in instances:
            continue
        for dtype in (torch.float32, torch.float64):
            ops = [t.to(dtype).contiguous() for t in ops64]
            C = ak._plan(*ops[0].shape, ops[0].element_size())
            t1, t25 = (device_ms(lambda: ak.admm_round(
                *ops, k, qp.over_relax, qp.sigma, plan=C), 50)
                for k in (1, 25))
            log(f"[sweep] b3 {name} {dtype} cluster={C}: 1 step {t1:.4f} "
                f"ms, 25 steps {t25:.4f} ms: {1e3 * (t25 - t1) / 24:.2f} us "
                f"per step, {1e3 * (t1 - (t25 - t1) / 24):.1f} us fixed")


def phase_main(results, iters, gate=False, path="main"):
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver

    cfg = _flagship_config(iters)
    dev = torch.device("cuda")
    _reset_counts()
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
    counts = _counts()
    rungs = _by_rung()
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
    log(f"[main] launches by rung: {rungs}")
    if not all(math.isfinite(v) for v in (lb, ub, hw)):
        raise AssertionError(f"non-finite bounds lb={lb} ub={ub} hw={hw}")
    _record_launches(results, counts, ("pdhg_halpern_cluster",
                                       "pdhg_halpern_tile", "admm_round"),
                     path)
    if counts["pdhg_halpern_round"] != 0:
        raise AssertionError(f"ssn main path left a rung on the row-block "
                             f"kernel: {rungs}")
    if gate:
        _f32_gate("[main]", lambda seed: solver.evaluate_ci(
            min_samples=4096, max_samples=4096, seed=seed))
    return lb, ub


# the storm phase: bench.py's storm_time_to_gap (bench.py:426-437, run by
# bench.py:_bench_sd_gap, :227-238) with its SD iterations cut from 1500
# to --storm-iters for the script's time limit; its MC bound must lie in
# STORM_UB: the literature optimum is about 15,498,740 (RESULTS.md:24), an
# MC estimate at a feasible decision cannot sit below it beyond sampling
# error (the reference's half-width: 5,059 at 1500 iterations), and the
# upper limit is 2 % above it
STORM_UB = (15_480_000.0, 15_810_000.0)
STORM_F64_ITERS = 20            # 30 until the same cut
# the legs under scheme="average": the f64 leg's SD panel (2 rows) is the
# one path of pdhg_average_stream, the f32 leg's bound (1024 stratified
# samples) the one path of pdhg_average_grid
STORM_AVG_ITERS = 10
STORM_AVG_SAMPLES = 1024
STORM_MORE_ITERS = 100      # added per look while mc_ub is above the band
# seconds the storm phase may spend on such looks: the default script takes
# 1116-1152 s of its 1200 s limit on the H100 (PERF.md), so about one look
STORM_EXTRA_S = 60.0


def _storm_solver(dtype, scheme="halpern"):
    """The reference bench's storm solver: SDConfig(pdhg=PDHGConfig(
    tol=1e-4, max_iters=80_000)) in ``dtype`` under the PDHG ``scheme``,
    from x0 = 0 projected onto storm's first-stage rows (SDSolver's
    default start), seed 0."""
    import torch
    from sqlp_tpu_torch.config import PDHGConfig, SDConfig
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver

    cfg = SDConfig(dtype=dtype, pdhg=PDHGConfig(scheme=scheme, tol=1e-4,
                                                max_iters=80_000))
    inst = load_instance("storm", dtype=cfg.jdtype,
                         device=torch.device("cuda"))
    return SDSolver(inst, cfg, seed=0)


def phase_storm(results, iters):
    """The storm path. f32: iters SD iterations, then evaluate_ci over
    8192 stratified samples at seed 7 (two 4096-row panels through the
    escalation ladder); while mc_ub sits above STORM_UB and the next look
    fits in STORM_EXTRA_S seconds, STORM_MORE_ITERS more iterations and a
    new bound (the gate fails on the last mc_ub when they are spent). f64:
    STORM_F64_ITERS iterations and one 4096-row stratified panel; then
    STORM_AVG_ITERS f64 iterations under scheme="average", and as many in
    f32 with a STORM_AVG_SAMPLES-sample stratified bound. Gates: both
    stream kernels and both grid kernels launched on the path, no
    row-block average round, no row-block Halpern round on the f32 leg at
    a rung the plan gives the grid kernel, every number finite, the f32
    mc_ub within STORM_UB."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    _reset_counts()
    solver = _storm_solver("float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.run(iters)
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    done = iters

    def bound():
        t = time.perf_counter()
        out = solver.evaluate_ci(min_samples=8192, max_samples=8192, seed=7,
                                 sampling="stratified")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (ub, hw, n), mc_s = bound()
    lb = solver.lower_estimate
    log(f"[storm] f32 {done} iters in {sd_s:.2f}s ({done / sd_s:.3f} it/s)"
        f" lb_est={lb:.4f} mc_ub={ub:.4f} +- {hw:.4f} (N={n}, "
        f"{mc_s:.2f}s) host_fallbacks={solver.host_fallback_count}")
    extra_s = 0.0
    while ub > STORM_UB[1] and extra_s + (sd_s / done) * STORM_MORE_ITERS \
            + mc_s <= STORM_EXTRA_S:
        t0 = time.perf_counter()
        solver.run(STORM_MORE_ITERS)
        torch.cuda.synchronize()
        sd_s += time.perf_counter() - t0
        done += STORM_MORE_ITERS
        (ub, hw, n), mc_s = bound()
        extra_s += time.perf_counter() - t0
        lb = solver.lower_estimate
        log(f"[storm] mc_ub above {STORM_UB[1]:.0f}: {STORM_MORE_ITERS} "
            f"more iterations, {done} in {sd_s:.2f}s: lb_est={lb:.4f} "
            f"mc_ub={ub:.4f} +- {hw:.4f} ({mc_s:.2f}s)")
    f32_rungs = _by_rung()
    f32_grid = _counts()["pdhg_halpern_grid"]
    m2, n2 = solver.inst.arrays.W.shape
    rows_at_grid = {B: v for (c, B, it), v in pk.launches_by_shape.items()
                    if c == "launches" and it == 4
                    and pk._plan(B, m2, n2, 4)[0] == "grid"}
    s64 = _storm_solver("float64")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s64.run(STORM_F64_ITERS)
    torch.cuda.synchronize()
    sd64_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ub64, hw64, n64 = s64.evaluate_ci(min_samples=4096, max_samples=4096,
                                      seed=7, sampling="stratified")
    torch.cuda.synchronize()
    mc64_s = time.perf_counter() - t0
    lb64 = s64.lower_estimate
    log(f"[storm] f64 {STORM_F64_ITERS} iters in {sd64_s:.2f}s "
        f"({STORM_F64_ITERS / sd64_s:.3f} it/s) lb_est={lb64:.4f} "
        f"mc_ub={ub64:.4f} +- {hw64:.4f} (N={n64}, {mc64_s:.2f}s) "
        f"host_fallbacks={s64.host_fallback_count}")
    halpern_rungs = _by_rung()
    t0 = time.perf_counter()
    savg = _storm_solver("float64", scheme="average")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    last = savg.run(STORM_AVG_ITERS)
    torch.cuda.synchronize()
    avg_s = time.perf_counter() - t1
    lb_avg = savg.lower_estimate
    inc_avg = float(last["inc_est"])
    log(f"[storm] f64 average {STORM_AVG_ITERS} iters in {avg_s:.2f}s "
        f"({time.perf_counter() - t0:.2f}s with the solver's set-up) "
        f"lb_est={lb_avg:.4f} inc_est={inc_avg:.4f} "
        f"host_fallbacks={savg.host_fallback_count}")
    t0 = time.perf_counter()
    s32 = _storm_solver("float32", scheme="average")
    s32.run(STORM_AVG_ITERS)
    ub_a32, hw_a32, n_a32 = s32.evaluate_ci(
        min_samples=STORM_AVG_SAMPLES, max_samples=STORM_AVG_SAMPLES, seed=7,
        sampling="stratified")
    torch.cuda.synchronize()
    lb_a32 = s32.lower_estimate
    counts = _counts()
    log(f"[storm] f32 average {STORM_AVG_ITERS} iters and a bound in "
        f"{time.perf_counter() - t0:.2f}s lb_est={lb_a32:.4f} "
        f"mc_ub={ub_a32:.4f} +- {hw_a32:.4f} (N={n_a32}) "
        f"host_fallbacks={s32.host_fallback_count}")
    log(f"[storm] launches: {json.dumps(counts)}")
    log(f"[storm] launches by rung (f32 leg): {f32_rungs}")
    log(f"[storm] launches by rung (both Halpern legs): {halpern_rungs}")
    log(f"[storm] launches by rung (all legs): {_by_rung()}")
    numbers = (lb, ub, hw, lb64, ub64, hw64, lb_avg, inc_avg, lb_a32, ub_a32,
               hw_a32)
    if not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"storm: non-finite numbers {numbers}")
    _record_launches(results, counts, ("pdhg_halpern_stream",
                                       "pdhg_average_stream",
                                       "pdhg_halpern_grid",
                                       "pdhg_average_grid", "admm_round"),
                     "storm")
    if f32_grid <= 0 or rows_at_grid:
        raise AssertionError(f"storm's f32 leg: {f32_grid} grid launches, "
                             f"row-block Halpern rounds at the grid "
                             f"kernel's rungs {rows_at_grid}: {f32_rungs}")
    if counts["pdhg_average_round"]:
        raise AssertionError(f"storm's average legs left the stream and grid "
                             f"kernels for the row-block round: {_by_rung()}")
    if not STORM_UB[0] <= ub <= STORM_UB[1]:
        raise AssertionError(f"storm mc_ub {ub} after {done} iterations "
                             f"({extra_s:.1f}s of {STORM_EXTRA_S:.0f}s "
                             f"spent on more looks) outside {STORM_UB}")
    return lb, ub


def _flagship_config(iters, scheme="halpern"):
    """The flagship CLI configuration (sqlp_tpu_torch/cli.py defaults with
    --schedule adaptive --rho 1e-3), capacities autoscaled to iters."""
    from sqlp_tpu_torch.config import (PDHGConfig, QPConfig, SDConfig,
                                       autoscale_capacities)
    cfg = SDConfig(dtype="float32", quad_schedule="adaptive",
                   quad_scalar_init=1e-3, max_cuts=96, scenarios_per_iter=1,
                   pdhg=PDHGConfig(scheme=scheme, tol=1e-4,
                                   max_iters=60_000),
                   qp=QPConfig(tol=1e-7, max_iters=4_000))
    return autoscale_capacities(cfg, iters)


def phase_profile(path, iters):
    """Where a path's time goes: ssn at the flagship settings (the main
    path's single SD run, or the replicated path's 8 lockstep replications
    under the restart-to-average scheme), a warm-up of iters iterations,
    then iters iterations with a synchronize and a host clock around each
    phase of the SD step, then 10 iterations under torch.profiler for the
    device's busy share and its time by kernel."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd import algorithm
    from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver

    tag = f"[profile {path}]"
    replicated = path == "replicated"
    cfg = _flagship_config(2 * iters + 10,
                           "average" if replicated else "halpern")
    inst = load_instance("ssn", dtype=cfg.jdtype)
    if replicated:
        solver = SDReplications(inst, cfg, n_replications=8,
                                x0=np.zeros(inst.n1), seed=0)
    else:
        solver = SDSolver(inst, cfg, x0=np.zeros(inst.n1), seed=0)
    solver.run(iters)
    spent = {}
    phases = {"recourse PDHG solve": "solve_batch", "master QP": "solve_qp",
              "crossover": "sharpen_duals", "dual pool": "push_duals",
              "cut build": "build_sasa_cut"}
    originals = {fn: getattr(algorithm, fn) for fn in phases.values()}

    def timed(label, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t
            return out
        return run

    for label, fn in phases.items():
        setattr(algorithm, fn, timed(label, originals[fn]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for fn, orig in originals.items():
            setattr(algorithm, fn, orig)
    log(f"{tag} ssn iterations {iters + 1}-{2 * iters} with a synchronize "
        f"at each phase edge: {wall:.3f}s ({iters / wall:.3f} it/s)")
    for label, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        log(f"{tag}   {label}: {sec:.3f}s ({100 * sec / wall:.1f} %)")
    rest = wall - sum(spent.values())
    log(f"{tag}   rest of the step (host): {rest:.3f}s "
        f"({100 * rest / wall:.1f} %)")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solver.run(10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e6
    log(f"{tag} 10 iterations under torch.profiler: wall {wall:.3f}s, "
        f"device busy {busy:.3f}s ({100 * busy / wall:.1f} % of the wall; "
        f"the profiler's host cost inflates the wall)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        log(f"{tag}   {e.key[:70]}: {e.device_time_total / 1e3:.1f} ms in "
            f"{e.count} launches")


def phase_profile_ef():
    """Where the certification EF's time goes: ssn, 8 extensive forms of
    CERT_FRESH stratified scenarios each (the certify phase's shapes), in
    f32,
    with the tolerance at 0 so every call runs its whole budget: a call
    of 2 restart rounds and one of 6, host clock around each (their
    difference is 4 rounds without the set-up), then 2 rounds under
    torch.profiler for the device's busy share and its time by kernel."""
    import torch
    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.models.crash import solve_extensive_form
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.models.scenario import sample_deltas
    from sqlp_tpu_torch.sd.lower_bound import stream_generator

    tag = "[profile ef]"
    dev = torch.device("cuda")
    inst = load_instance("ssn", dtype=torch.float32, device=dev)
    R, S = 8, CERT_FRESH
    deltas = torch.stack([sample_deltas(stream_generator(dev, 9000, r),
                                        inst.scenario_model, S,
                                        method="stratified")
                          for r in range(R)])
    probs = torch.full((S,), 1.0 / S, dtype=torch.float32, device=dev)

    def solve(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve_extensive_form(inst.arrays, inst.scenario_model, deltas, probs,
                             PDHGConfig(tol=0.0, max_iters=80 * rounds))
        torch.cuda.synchronize()
        return time.perf_counter() - t

    solve(1)
    short, long_ = solve(2), solve(6)
    log(f"{tag} ssn R={R} S={S} f32: 2 rounds {short:.3f}s, 6 rounds "
        f"{long_:.3f}s: {1e3 * (long_ - short) / 4:.2f} ms per 80-step "
        f"round, {1e3 * (long_ - short) / 320:.3f} ms per step; set-up "
        f"{short - (long_ - short) / 2:.3f}s")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve_extensive_form(inst.arrays, inst.scenario_model, deltas, probs,
                             PDHGConfig(tol=0.0, max_iters=160))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e6
    log(f"{tag} 2 rounds under torch.profiler: wall {wall:.3f}s, device "
        f"busy {busy:.3f}s ({100 * busy / wall:.1f} % of the wall)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        log(f"{tag}   {e.key[:70]}: {e.device_time_total / 1e3:.1f} ms in "
            f"{e.count} launches")


# each PDHG kernel's counter in pdhg_kernel.launches_by_shape
_PDHG_COUNTERS = {"pdhg_halpern_round": "launches",
                  "pdhg_halpern_cluster": "cluster_launches",
                  "pdhg_halpern_tile": "tile_launches",
                  "pdhg_halpern_stream": "stream_launches",
                  "pdhg_halpern_grid": "grid_launches",
                  "pdhg_average_round": "average_launches",
                  "pdhg_average_cluster": "average_cluster_launches",
                  "pdhg_average_tile": "average_tile_launches",
                  "pdhg_average_stream": "average_stream_launches",
                  "pdhg_average_grid": "average_grid_launches",
                  "pdhg_halpern_small": "small_launches",
                  "pdhg_average_small": "average_small_launches"}


def _reset_counts():
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    pk.launches_by_shape.clear()
    ak.launches = 0
    ak.batched_launches = 0


def _counts():
    from sqlp_tpu_torch.ops.cuda import admm_kernel as ak
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    by_counter = pk.launch_counts()
    out = {k: by_counter[attr] for k, attr in _PDHG_COUNTERS.items()}
    out["admm_round"] = ak.launches
    out["admm_round_batched"] = ak.batched_launches
    return out


def _by_rung():
    """The PDHG launches since the last reset as 'kernel B=.. f32|f64: n',
    largest panels first: which rung of the path took which variant."""
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    names = {attr: k for k, attr in _PDHG_COUNTERS.items()}
    rows = sorted(pk.launches_by_shape.items(),
                  key=lambda kv: (kv[0][0], kv[0][2], -kv[0][1]))
    return "; ".join(f"{names[c]} B={B} f{8 * it}: {v}"
                     for (c, B, it), v in rows)


def _record_launches(results, counts, keys, path):
    """The path's launches of every kernel (``counts``, read from a reset
    just before the path to a read just after it); a kernel's ``launches``
    is the sum over the paths that were read, 0 included, and
    ``launches_by_path`` the parts that launched it. Fails unless each
    kernel in ``keys`` launched on the path."""
    for k, entry in results.items():
        by_path = entry.setdefault("launches_by_path", {})
        if counts[k]:
            by_path[path] = counts[k]
        entry["launches"] = sum(by_path.values())
    missing = [k for k in keys if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the path never launched {missing}: {counts}")


GATE_SEEDS = (1, 2, 3)


def _f32_tiles_as_rows(pk, real):
    """The plan function ``real`` with every float32 tile plan replaced by
    the row-block kernel's: the gate's partner over a whole solve. The
    float64 rung keeps its plan, so the runs differ in the float32
    products alone."""

    def plan(B, m, n, itemsize, scheme="halpern"):
        out = real(B, m, n, itemsize, scheme)
        if out[0] != "tile" or itemsize != 4:
            return out
        return ("rows", pk._rows_per_block(
            f"pdhg_{scheme}_round", B,
            pk._row_values(m, n, scheme) * itemsize))
    return plan


def _f32_gate(tag, evaluate):
    """The gate of the tile kernel's float32 products. ``evaluate(seed)``
    solves one 4096-row panel at the path's x and returns (mean,
    half-width, n). Every seed's panel goes through the row-block kernel
    (plain FP32 FMAs) and through the path's own plans, whose float32
    tiles run FP32 FMAs in the tile kernel's tiles, exchange and summation
    order. It passes when the tile kernel's total rounds over the seeds
    are within 5 % of the row-block kernel's and every seed's mean is
    within the larger half-width of the row-block kernel's. Single panels
    differ by up to 20 % between the kernels (a few stragglers' restarts
    decide the tail), so the seeds' rounds are printed one by one and
    judged in total."""
    import torch
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    saved = dict(pk.launches_by_shape)
    real = pk._plan
    plans = {"rows": _f32_tiles_as_rows(pk, real), "tile": real}
    rounds = {k: 0 for k in plans}
    means_ok = True
    try:
        for seed in GATE_SEEDS:
            ref = None
            for kind, plan in plans.items():
                pk._plan = plan
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ub, hw, _ = evaluate(seed)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                n = sum(_counts()[k] for k in _PDHG_COUNTERS)
                rounds[kind] += n
                if ref is None:
                    ref = (ub, hw)
                elif abs(ub - ref[0]) > max(hw, ref[1]):
                    means_ok = False
                log(f"{tag} gate seed {seed} {kind}: {n} rounds, mc_ub="
                    f"{ub:.6f} +- {hw:.4f}, {sec:.2f}s; {_by_rung()}")
    finally:
        pk._plan = real
    # the path's own counts stand as they were read before the gate
    _reset_counts()
    pk.launches_by_shape.update(saved)

    apart = abs(rounds["tile"] - rounds["rows"]) / max(rounds["rows"], 1)
    limit = 0.05
    ok = apart <= limit and means_ok
    log(f"{tag} f32 gate: the tile kernel's {rounds['tile']} rounds over "
        f"seeds {GATE_SEEDS} against the row-block kernel's "
        f"{rounds['rows']}: {100 * apart:.2f} % (limit {100 * limit:.0f} %), "
        f"means within the half-width: {means_ok}: "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the tile kernel's float32 products fail their "
                             "gate against the row-block kernel")


def phase_replicated(results, iters):
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.compromise import compromise_decision
    from sqlp_tpu_torch.sd.driver import SDReplications

    # the flagship settings under the restart-to-average scheme: every
    # recourse solve (SD panel, MC panel, f64 rung) runs kernel B2
    cfg = _flagship_config(iters, "average")
    dev = torch.device("cuda")
    R = 8
    _reset_counts()
    inst = load_instance("ssn", dtype=cfg.jdtype, device=dev)
    reps = SDReplications(inst, cfg, n_replications=R,
                          x0=np.zeros(inst.n1), seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = reps.run(iters)
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    x_comp, info = compromise_decision(inst, reps.states, reps.especs,
                                       rho=1.0, qp_config=cfg.qp,
                                       obj_scale=reps.obj_scale)
    comp_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    ub, hw, n = reps.evaluate_ci(x=x_comp, min_samples=4096,
                                 max_samples=4096, seed=1,
                                 sampling="stratified")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t2
    counts = _counts()
    rungs = _by_rung()
    lbs = reps.lower_estimates
    log(f"[replicated] ssn R={R} x {iters} iters in {sd_s:.2f}s "
        f"({iters / sd_s:.3f} it/s, {R * iters / sd_s:.2f} "
        f"replication-it/s)")
    log("[replicated] lb_est per replication: "
        + " ".join(f"{v:.6f}" for v in lbs))
    log(f"[replicated] compromise in {comp_s:.2f}s "
        f"(qp_converged={bool(info['qp_converged'])}, projection "
        f"{info['projection_distance']:.3g}); mc_ub={ub:.6f} +- {hw:.4f} "
        f"(N={n}, stratified, {eval_s:.2f}s) "
        f"host_fallbacks={reps.host_fallback_count}")
    log("[replicated] last step (replication 0): " + " ".join(
        f"{k}={float(last[k][0]):.6g}" for k in (
            "pdhg_rounds", "pdhg_iters", "pdhg_err_max", "qp_iters",
            "qp_err", "n_duals", "n_cuts_live", "crossover_accepted")))
    log(f"[replicated] launches: {json.dumps(counts)}")
    log(f"[replicated] launches by rung: {rungs}")
    vals = [*lbs, *x_comp, ub, hw]
    if not all(math.isfinite(float(v)) for v in vals):
        raise AssertionError(f"non-finite results lb={lbs} x={x_comp} "
                             f"ub={ub} hw={hw}")
    _record_launches(results, counts, ("pdhg_average_cluster",
                                       "pdhg_average_tile"), "replicated")
    if counts["admm_round"] <= 0:
        raise AssertionError(f"replicated path never launched B3: {counts}")
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk
    panel = {c for (c, B, it) in pk.launches_by_shape if (B, it) == (2 * R, 4)}
    if panel != {"average_cluster_launches"}:
        raise AssertionError(f"the {2 * R}-row SD panel did not go through "
                             f"B2's cluster variant alone: {rungs}")
    if any(counts[k] for k in ("pdhg_halpern_round", "pdhg_halpern_cluster",
                               "pdhg_halpern_tile", "pdhg_average_round")):
        raise AssertionError(f"replicated path launched a Halpern kernel "
                             f"under scheme='average', or left a rung on "
                             f"the row-block kernel: {rungs}")
    _f32_gate("[replicated]", lambda seed: reps.evaluate_ci(
        x=x_comp, min_samples=4096, max_samples=4096, seed=seed,
        sampling="stratified"))


# SD iterations of each small-path run (40 until the surface phase, which
# also drives lands through the small kernels, needed the time)
SMALL_ITERS = 20
# the small path's runs: (instance, scheme, replications, x0); transship
# and baa99-20 from the port's default first-stage point
SMALL_RUNS = (("lands", "halpern", 1, 5.0), ("lands", "average", 3, 5.0),
              ("transship", "halpern", 1, None),
              ("baa99-20", "halpern", 1, None))


def phase_small(results):
    """The small path: the instances whose K (under 128 KB) takes the
    small kernels. lands: a single SD run under the Halpern scheme with its
    MC bound, then 3 lockstep replications under the average scheme with
    theirs; transship and baa99-20: a single run under the Halpern scheme
    in float32 at the port's defaults and its MC bound; SMALL_ITERS
    iterations and a 1024-row panel each, each driven with the counts reset
    before and read after. Fails on a non-finite bound, or unless the
    scheme's small kernel launched."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.config import PDHGConfig, SDConfig
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver

    dev = torch.device("cuda")
    for name, scheme, reps, x0 in SMALL_RUNS:
        inst = load_instance(name, dtype=torch.float32, device=dev)
        x0 = None if x0 is None else np.full(inst.n1, x0)
        cfg = SDConfig(dtype="float32", pdhg=PDHGConfig(scheme=scheme))
        _reset_counts()
        t0 = time.perf_counter()
        if reps == 1:
            solver = SDSolver(inst, cfg, x0=x0, seed=0)
        else:
            solver = SDReplications(inst, cfg, n_replications=reps, x0=x0,
                                    seed=0)
        solver.run(SMALL_ITERS)
        x = None if reps == 1 else solver.x_incumbents[0]
        ub, hw, n = solver.evaluate_ci(x=x, min_samples=1024,
                                       max_samples=1024, seed=1)
        torch.cuda.synchronize()
        counts = _counts()
        log(f"[small] {name} scheme={scheme}: {SMALL_ITERS} iterations + a "
            f"{n}-row MC panel in {time.perf_counter() - t0:.2f}s, "
            f"mc_ub={ub:.4f} +- {hw:.4f}; launches by rung: {_by_rung()}")
        if not (math.isfinite(ub) and math.isfinite(hw)):
            raise AssertionError(f"non-finite {name} bound {ub} +- {hw}")
        _record_launches(results, counts, (f"pdhg_{scheme}_small",),
                         f"small {name} {scheme}")


# the surface phase: the port's packages, each re-exporting the names of
# its JAX counterpart's __init__ (tests/test_torch_public_surface.py holds
# the lists to the JAX package's on the CPU); lands runs of SURFACE_ITERS
# SD iterations (40 until the phase outgrew its 20 s: a lands iteration
# takes about 0.23 s on the card, most of it the master's ADMM intervals,
# each read by the host); SURFACE_EF_SCENARIOS fresh certification
# scenarios for each of the R = 2 lands replications of SURFACE_REP_ITERS
# iterations
SURFACE_PACKAGES = ("sqlp_tpu_torch", "sqlp_tpu_torch.models",
                    "sqlp_tpu_torch.ops", "sqlp_tpu_torch.parallel",
                    "sqlp_tpu_torch.sd", "sqlp_tpu_torch.utils")
SURFACE_ITERS = 20
SURFACE_REP_ITERS = 10
SURFACE_EF_SCENARIOS = 64
# the EF's tolerance (the certified path's 1e-5 takes about 8000 iterations
# on lands at 0.46 ms each, launch-bound; 1e-4 about 900) and the f64
# continuation's cap (4000 by default; on lands it stops on the cap either
# way): the gates hold the bounds to validity, not to tightness
SURFACE_EF_TOL = 1e-4
SURFACE_REFINE_ITERS = 1000
# saa_ef_bound's dual repairs: the default projection, the raw EF duals
# with no host re-solve, no f64 continuation
SURFACE_EF_OPTIONS = ({}, {"refine_duals": False, "host_exact_cap": 0},
                      {"refine_f64": False})


def _differing_fields(a, b):
    """The names of the SDState fields that differ in any bit."""
    import torch
    return [f for f in a.__dataclass_fields__
            if not (torch.equal(getattr(a, f), getattr(b, f))
                    if torch.is_tensor(getattr(a, f))
                    else getattr(a, f) == getattr(b, f))]


def phase_surface(results):
    """The public surface on the card: every name the port's package
    ``__init__``s re-export; ``solve_instance("lands", SURFACE_ITERS)``
    (the CLI's subproblem tolerance and iteration cap, seed 0) held bit
    for bit to ``SDSolver(load_instance("lands"), cfg, seed=0).run``; then
    ``saa_ef_bound`` on R = 2 lands replications in float64 over
    SURFACE_EF_SCENARIOS fresh scenarios under each of
    SURFACE_EF_OPTIONS. Gates: every bound finite and at most its EF
    objective (1e-6 relative), no host re-solve under cap 0, the row-block
    Halpern round and B3 launched."""
    import importlib

    import numpy as np
    import torch

    t0 = time.perf_counter()
    n_names = 0
    for p in SURFACE_PACKAGES:
        mod = importlib.import_module(p)
        for name in mod.__all__:
            getattr(mod, name)
            n_names += 1
    from sqlp_tpu_torch import SDConfig
    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.models import load_instance
    from sqlp_tpu_torch.sd import SDSolver, solve_instance
    from sqlp_tpu_torch.sd.driver import SDReplications
    from sqlp_tpu_torch.sd.lower_bound import saa_ef_bound
    log(f"[surface] {n_names} names of {len(SURFACE_PACKAGES)} packages "
        f"imported in {time.perf_counter() - t0:.2f}s")

    _reset_counts()
    cfg = SDConfig(pdhg=PDHGConfig(tol=1e-4, max_iters=60_000))
    t0 = time.perf_counter()
    got = solve_instance("lands", SURFACE_ITERS, config=cfg, seed=0,
                         verbose=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = SDSolver(load_instance("lands"), cfg, seed=0)
    ref.run(SURFACE_ITERS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    differ = _differing_fields(got.state, ref.state)
    log(f"[surface] solve_instance lands {SURFACE_ITERS} iters "
        f"{t1 - t0:.2f}s, SDSolver.run {t2 - t1:.2f}s: lb_est "
        f"{got.lower_estimate:.6f} / {ref.lower_estimate:.6f}, state "
        f"bit for bit: {not differ}")
    if differ:
        raise AssertionError(f"solve_instance differs from SDSolver.run in "
                             f"{differ}")

    cfg64 = SDConfig(dtype="float64", max_scenarios=64, max_dual_vertices=64,
                     max_cuts=16, pdhg=PDHGConfig(tol=1e-4))
    t0 = time.perf_counter()
    reps = SDReplications(load_instance("lands", dtype=torch.float64), cfg64,
                          n_replications=2, x0=np.full(4, 3.0), seed=0)
    reps.run(SURFACE_REP_ITERS)
    torch.cuda.synchronize()
    log(f"[surface] lands f64 R=2 x {SURFACE_REP_ITERS} iters in "
        f"{time.perf_counter() - t0:.2f}s")
    ef_config = PDHGConfig(tol=SURFACE_EF_TOL, max_iters=400_000)
    for opts in SURFACE_EF_OPTIONS:
        t0 = time.perf_counter()
        out = saa_ef_bound(reps.arrays, reps.scenario_model, reps.espec,
                           reps.states, reps.config,
                           obj_scale=reps.obj_scale, ef_config=ef_config,
                           fresh_scenarios=SURFACE_EF_SCENARIOS,
                           refine_iters=SURFACE_REFINE_ITERS, **opts)
        sec = time.perf_counter() - t0
        lb, ef = out["lb_per_rep"], out["ef_obj_per_rep"]
        log(f"[surface] saa_ef_bound {json.dumps(opts)}: lb {lb.tolist()} "
            f"ef_obj {ef.tolist()} ef_iters {out['ef_iters_per_rep'].tolist()}"
            f" dual_infeas {out['dual_infeas_per_rep'].tolist()} host_exact "
            f"{out['host_exact_count']} n_unrefined {out['n_unrefined']} "
            f"in {sec:.2f}s ({json.dumps(out['seconds'])})")
        if not (np.all(np.isfinite(lb))
                and np.all(lb <= ef + 1e-6 * np.abs(ef))):
            raise AssertionError(f"saa_ef_bound {opts}: bounds {lb} not "
                                 f"finite or above the EF objectives {ef}")
        if opts.get("host_exact_cap") == 0 and out["host_exact_count"]:
            raise AssertionError(f"saa_ef_bound {opts}: "
                                 f"{out['host_exact_count']} host re-solves")
    counts = _counts()
    _record_launches(results, counts, ("pdhg_halpern_small", "admm_round"),
                     "surface")


# the mesh phase: lands in float64 on a 2x2 mesh against one rank, the
# capacities and tolerances of tests/test_parallel.py:47-52, on the scenario
# values of tests/test_torch_mesh.py; then ssn at the flagship CLI settings
# on a 1-D mesh of 2 ranks with the pool sharded, at the flagship
# capacities
MESH_LANDS_STEPS = 12
# 100, then 50, then 25 until the storm phase, the script's time limit
# and then the small kernels' cases needed the time
MESH_SSN_ITERS = 15
MESH_ATOL = 1e-8


def _mesh_lands_solver(mesh_shape=None):
    import numpy as np
    import torch
    from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver

    cfg = SDConfig(dtype="float64", max_scenarios=256, max_dual_vertices=64,
                   max_cuts=16, pdhg=PDHGConfig(tol=1e-8, max_iters=10_000),
                   qp=QPConfig(tol=1e-9, max_iters=4_000))
    inst = load_instance("lands", dtype=torch.float64, device="cuda")
    return SDSolver(inst, cfg, x0=np.full(4, 3.0), seed=3,
                    mesh_shape=mesh_shape)


def _mesh_lands_steps(solver):
    """MESH_LANDS_STEPS steps on numpy-drawn lands scenario values (the
    seed and draw of tests/test_torch_slice.py's lands stream); returns
    the candidates [steps, n1]."""
    import numpy as np
    support = solver.inst.scenario_model.values[0].cpu().numpy()
    values = np.random.default_rng(11).choice(support,
                                              size=MESH_LANDS_STEPS)
    xs = []
    for v in values:
        solver.step_scenarios(values=np.full((1, 1, 1), v))
        xs.append(solver.x_candidate)
    return np.stack(xs)


def mesh_lands_rank(rank: int, world: int, port: int, out: str,
                    device: str = "cuda:0") -> None:
    """One rank of the mesh phases' lands run (started by phase_mesh and
    phase_mesh_nccl): joins the group on ``device`` (Gloo when the ranks
    share cuda:0, NCCL when each has a card), steps the 2x2 mesh, checks
    that the replicated fields agree across ranks, prints its backend and
    launches on standard error; rank 0 saves the candidates to
    ``out``."""
    import numpy as np
    from sqlp_tpu_torch.parallel import distributed
    from sqlp_tpu_torch.parallel.mesh import check_replicated
    from sqlp_tpu_torch.utils.torchsetup import configure_torch

    configure_torch()
    distributed.init_distributed(f"127.0.0.1:{port}", world, rank, device,
                                 timeout_s=300)
    print(f"chip_smoke backend: {distributed.backend()} "
          f"({distributed.layout_summary()})", file=sys.stderr)
    try:
        solver = _mesh_lands_solver(mesh_shape=(2, 2))
        _reset_counts()
        xs = _mesh_lands_steps(solver)
        counts = _counts()
        n = check_replicated(solver.state, solver.mesh)
        print(f"chip_smoke replicated: {n} fields bitwise equal",
              file=sys.stderr)
        print("chip_smoke launches: " + json.dumps(counts), file=sys.stderr)
        if rank == 0:
            np.save(out, xs)
    finally:
        distributed.shutdown()


def _wait_ranks(tag, procs, limit_s):
    """Wait for rank processes {name: (proc, out, err, t0)}; returns {name:
    (stdout, stderr, seconds)} or raises when one failed or ran past
    limit_s (all are killed then)."""
    got, failed = {}, []
    for name, (proc, out, err, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, limit_s - (time.perf_counter()
                                                       - t0)))
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other[0].kill()
            rc = "timeout"
        got[name] = (_read(out), _read(err), time.perf_counter() - t0)
        if rc != 0:
            failed.append(name)
            log(f"[mesh] {tag} {name}: rc={rc} {got[name][1][-2000:]}")
    if failed:
        raise AssertionError(f"[mesh] {tag}: ranks failed: {failed}")
    return got


def _rank_counts(tag, name, err):
    m = re.search(r"chip_smoke launches: (\{.*\})", err)
    if m is None:
        raise AssertionError(f"[mesh] {tag} {name}: no launch counts")
    return json.loads(m.group(1))


def _mesh_lands(tag, device_of, results=None):
    """The 2x2 lands run: 4 rank processes (rank r on ``device_of(r)``)
    against a single-rank run here, held within MESH_ATOL at every step;
    returns the ranks' standard errors."""
    import tempfile
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    port = _free_port()
    code = ("import sys, chip_smoke\n"
            "chip_smoke.mesh_lands_rank(*map(int, sys.argv[1:4]), "
            "*sys.argv[4:6])\n")
    out_x = os.path.join(tmp, "x.npy")
    procs = {}
    for r in range(4):
        proc, o, e = _cli([str(r), "4", str(port), out_x, device_of(r)],
                          code=code)
        procs[f"rank{r}"] = (proc, o, e, time.perf_counter())
    _reset_counts()
    single = _mesh_lands_steps(_mesh_lands_solver())
    counts = _counts()
    got = _wait_ranks(f"{tag} lands 2x2", procs, 300)
    xs = np.load(out_x)
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    dx = np.abs(xs - single).max(axis=1)
    log(f"[{tag}] lands f64 2x2, {MESH_LANDS_STEPS} steps: max |x_mesh - "
        f"x_single| per step {np.array2string(dx, precision=2)}; rank "
        f"seconds {', '.join(f'{v[2]:.1f}' for v in got.values())}; "
        f"single-rank launches {json.dumps(counts)}")
    for name, (_, err, _) in got.items():
        c = _rank_counts("lands", name, err)
        backend = re.search(r"chip_smoke backend: (.*)", err)
        log(f"[{tag}] lands {name} ({backend.group(1) if backend else '?'})"
            f" launches: {json.dumps(c)}")
        if results is not None:
            _record_launches(results, c, ("pdhg_halpern_small",
                                          "admm_round"),
                             f"mesh_lands_{name}")
        if "chip_smoke replicated:" not in err:
            raise AssertionError(f"[{tag}] lands {name}: no replicated "
                                 f"check")
    if not float(dx.max()) <= MESH_ATOL:
        raise AssertionError(f"[{tag}] lands 2x2 mesh left the single-rank "
                             f"run: {dx}")
    return {k: v[1] for k, v in got.items()}


def phase_mesh_nccl():
    """Not default (needs 4 cards): the lands 2x2 run of phase_mesh with
    rank r on cuda:r, so the ranks join over NCCL, against one rank; then
    ``solve ssn --mesh 2 --mesh-duals 2`` for 20 iterations, the command
    starting its 4 ranks itself (rank i on cuda:i): bounds finite, NCCL
    chosen, the replicated fields bitwise equal on the 4 ranks."""
    import torch
    if torch.cuda.device_count() < 4:
        raise AssertionError(f"mesh_nccl needs 4 cards, the host has "
                             f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    errs = _mesh_lands("mesh_nccl", lambda r: f"cuda:{r}")
    if not all("chip_smoke backend: nccl" in e for e in errs.values()):
        raise AssertionError("[mesh_nccl] the lands ranks did not choose "
                             "NCCL")
    proc, o, e = _cli(["solve", "ssn", "--iters", "20", "--schedule",
                       "adaptive", "--rho", "1e-3", "--device", "cuda",
                       "--mesh", "2", "--mesh-duals", "2",
                       "--eval-samples", "1000"])
    got = _wait_ranks("ssn 2x2", {"cli": (proc, o, e, time.perf_counter())},
                      600)
    out, err, sec = got["cli"]
    for line in err.splitlines():
        if line.startswith(("mesh", "done:")):
            log(f"[mesh_nccl] ssn: {line}")
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+) \(95% \+- (\S+),", out)
    if m is None or not all(math.isfinite(float(v)) for v in m.groups()):
        raise AssertionError(f"[mesh_nccl] ssn bounds: {out}")
    log(f"[mesh_nccl] ssn 2x2 over 4 cards, 20 iterations: lb_est="
        f"{m.group(1)} mc_ub={m.group(2)} +- {m.group(3)} in {sec:.1f}s")
    if "over nccl: 4 ranks, each on a GPU of its own" not in err or \
            "replicated state fields bitwise equal on 4 ranks" not in err:
        raise AssertionError("[mesh_nccl] ssn: NCCL not chosen or the "
                             "replicated check missing")
    log(f"[mesh_nccl] {time.perf_counter() - t0:.1f}s")


def phase_mesh(results):
    """Multi-device SD on one card: every rank a process with its own CUDA
    context on cuda:0, the ranks joined over Gloo (NCCL refuses two ranks
    on one GPU), each launching B1 and B3 on its own part of the work.
    (a) lands in float64 on a 2x2 (duals x scenarios) mesh, 4 ranks, for
        MESH_LANDS_STEPS steps on supplied scenario values, held at every
        step within MESH_ATOL of a single-rank run of the same values here;
    (b) ssn at the flagship CLI settings, --mesh 2 --shard-duals at the
        flagship capacities S 4096, D 2048, MESH_SSN_ITERS iterations and
        the 1000-sample MC bound, 2 ranks through --coordinator: bounds
        finite, the replicated fields bitwise equal on both ranks (the
        CLI's own check), B1's cluster and tile kernels and B3 launched on
        each rank.
    These times are not a multi-GPU scaling figure: the ranks share one
    card and the host's cores."""
    t0 = time.perf_counter()
    _mesh_lands("mesh", lambda r: "cuda:0", results)

    # (b) ssn, 2 ranks through --coordinator, each counting its launches
    port = _free_port()
    args = ["solve", "ssn", "--iters", str(MESH_SSN_ITERS), "--schedule",
            "adaptive", "--rho", "1e-3", "--device", "cuda", "--mesh", "2",
            "--shard-duals", "--no-auto-capacity", "--max-scenarios",
            "4096", "--max-duals", "2048", "--eval-samples", "1000",
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = {}
    for r in range(2):
        proc, o, e = _cli(args + ["--process-id", str(r)], counted=True)
        procs[f"rank{r}"] = (proc, o, e, time.perf_counter())
    got = _wait_ranks("ssn", procs, 600)
    out, err, _ = got["rank0"]
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+) \(95% \+- (\S+),", out)
    if m is None:
        raise AssertionError(f"[mesh] ssn rank 0 printed no bounds: {out}")
    lb, ub, hw = map(float, m.groups())
    for line in err.splitlines():
        if line.startswith(("mesh", "done:")):
            log(f"[mesh] ssn rank0: {line}")
    log(f"[mesh] ssn --mesh 2 --shard-duals S 4096 D 2048, "
        f"{MESH_SSN_ITERS} iterations: lb_est={lb:.6f} mc_ub={ub:.6f} +- "
        f"{hw:.4f}; rank seconds "
        f"{', '.join(f'{v[2]:.1f}' for v in got.values())}")
    if not all(math.isfinite(v) for v in (lb, ub, hw)):
        raise AssertionError(f"[mesh] ssn bounds not finite: {lb} {ub}")
    if "replicated state fields bitwise equal on 2 ranks" not in err:
        raise AssertionError("[mesh] ssn: no replicated-fields check")
    if got["rank1"][0].strip():
        raise AssertionError(f"[mesh] ssn rank 1 printed: {got['rank1'][0]}")
    for name, (_, err, _) in got.items():
        c = _rank_counts("ssn", name, err)
        log(f"[mesh] ssn {name} launches: {json.dumps(c)}")
        _record_launches(results, c, ("pdhg_halpern_cluster",
                                      "pdhg_halpern_tile", "admm_round"),
                         f"mesh_ssn_{name}")
    log(f"[mesh] lands and ssn in {time.perf_counter() - t0:.1f}s")


# the certify phase's gates (RESULTS.md round 5 measured |lb - ef_obj| at
# 0.01-0.05 on ssn at EF tol 1e-5)
CERT_EF_TOL = 1e-5
CERT_DUAL_INFEAS = 1e-9
CERT_LB_TO_EF = 0.1
# fresh scenarios per replication of the certify phase's EFs, which
# cert_polish reuses: 3000 until the script outgrew its 1200 s, then 1000
# until the default script took 1168.6 s on a slow host with the small
# kernels' cases (the EF's time and the bundle's panels scale with it)
CERT_FRESH = 600


def phase_certify(results, iters, eval_samples):
    """The certified path: ssn at the flagship settings (Halpern, f32),
    8 lockstep replications for ``iters`` iterations from x0 = 0, seed 0,
    the compromise decision and its stratified bound, then the CLI's own
    certify tail (``cli.certify_replications``): 8 extensive forms of
    CERT_FRESH fresh Latin-hypercube scenarios each at tol 1e-5 with their f64
    continuation, the dual projection, the host LPs, the decision among
    the compromise and the EF argmins on a shared panel, the winner on an
    independent one."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.cli import certify_replications
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.compromise import compromise_decision
    from sqlp_tpu_torch.sd.driver import SDReplications

    cfg = _flagship_config(iters)
    dev = torch.device("cuda")
    R = 8
    _reset_counts()
    inst = load_instance("ssn", dtype=cfg.jdtype, device=dev)
    reps = SDReplications(inst, cfg, n_replications=R,
                          x0=np.zeros(inst.n1), seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps.run(iters)
    torch.cuda.synchronize()
    sd_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    x_comp, info = compromise_decision(inst, reps.states, reps.especs,
                                       rho=1.0, qp_config=cfg.qp,
                                       obj_scale=reps.obj_scale)
    ub_comp, hw_comp, _ = reps.evaluate_ci(
        x=x_comp, min_samples=eval_samples, max_samples=eval_samples,
        seed=20_000, sampling="stratified")
    comp_s = time.perf_counter() - t1
    out = certify_replications(reps, x_comp, ub_comp, hw_comp, method="ef",
                               fresh_scenarios=CERT_FRESH,
                               eval_samples=eval_samples, seed=0)
    torch.cuda.synchronize()
    counts = _counts()
    rungs = _by_rung()
    cert = out["cert"]
    sec = cert["seconds"]
    tag = "[certify]"
    log(f"{tag} ssn R={R} x {iters} SD iterations in {sd_s:.2f}s "
        f"({iters / sd_s:.3f} it/s); compromise and its {eval_samples}-"
        f"sample stratified bound in {comp_s:.2f}s: {ub_comp:.6f} +- "
        f"{hw_comp:.4f}")
    log(f"{tag} certification over {cert['n_scenarios']}-scenario streams "
        f"in {out['seconds']['certify']:.2f}s: EF {sec['ef']:.2f}s, f64 "
        f"refine {sec['refine']:.2f}s, projection {sec['projection']:.2f}s,"
        f" host (corrections, HiGHS) {sec['host']:.2f}s")
    ef_s = sec["ef"] / max(int(np.max(cert["ef_iters_per_rep"])), 1) * 80
    log(f"{tag} EF iterations per replication "
        f"{cert['ef_iters_per_rep'].tolist()} ({1e3 * ef_s:.2f} ms per "
        f"80-step round of the slowest), f64 refine iterations "
        f"{cert['refine_iters_per_rep'].tolist()}")
    for k in ("lb_per_rep", "ef_obj_per_rep", "ef_err_first_per_rep",
              "ef_err_per_rep", "dual_infeas_per_rep",
              "cut_correction_per_rep"):
        log(f"{tag} {k}: " + " ".join(f"{v:.6g}" for v in cert[k]))
    log(f"{tag} host_exact_count={cert['host_exact_count']}")
    for name, (mean, hw, moved) in (out["selection"] or {}).items():
        log(f"{tag} selection {name}: {mean:.6f} +- {hw:.4f} (projected "
            f"{moved:.3g})")
    log(f"{tag} selection {out['seconds']['select']:.2f}s, final panel "
        f"{out['seconds']['final']:.2f}s: decision={out['decision']} ub="
        f"{out['ub']:.6f} +- {out['ub_hw']:.4f}")
    log(f"{tag} lb_cert={out['lb_cert']:.6f} (mean {cert['lb_mean']:.6f} "
        f"hw {cert['lb_half_width']:.6f}) cert_gap={out['cert_gap']:.5f}")
    log(f"{tag} launches: {json.dumps(counts)}")
    log(f"{tag} launches by rung: {rungs}")
    nums = [*cert["lb_per_rep"], *cert["ef_obj_per_rep"],
            *cert["ef_err_per_rep"], *cert["dual_infeas_per_rep"],
            *cert["cut_correction_per_rep"], out["lb_cert"], out["ub"],
            out["ub_hw"], out["cert_gap"], *np.ravel(out["x"])]
    if not all(math.isfinite(float(v)) for v in nums):
        raise AssertionError("non-finite certification numbers")
    if (np.max(cert["ef_err_first_per_rep"]) > CERT_EF_TOL
            or np.max(cert["ef_err_per_rep"]) > CERT_EF_TOL):
        raise AssertionError(f"an EF missed tol {CERT_EF_TOL}")
    if np.max(cert["dual_infeas_per_rep"]) > CERT_DUAL_INFEAS:
        raise AssertionError(f"dual infeasibility above {CERT_DUAL_INFEAS}")
    gap = np.abs(cert["lb_per_rep"] - cert["ef_obj_per_rep"])
    if np.max(gap) > CERT_LB_TO_EF:
        raise AssertionError(f"a bound is {np.max(gap):.4f} from its EF "
                             f"objective (limit {CERT_LB_TO_EF})")
    if not out["lb_cert"] < out["ub"] + out["ub_hw"]:
        raise AssertionError("lb_cert is not below the decision's ub + hw")
    _record_launches(results, counts, ("pdhg_halpern_cluster",
                                       "pdhg_halpern_tile", "admm_round"),
                     "certify")
    if any(counts[k] for k in ("pdhg_average_round", "pdhg_average_cluster",
                               "pdhg_average_tile")):
        raise AssertionError(f"the certified path launched an average "
                             f"kernel: {rungs}")
    return {"reps": reps, "x_comp": x_comp, "out": out}


def phase_cert_polish(results, memo):
    """The rest of the certified bounds on the certify phase's 8 ssn
    replication states (no extra SD): the ef_polish route (4 level-bundle
    rounds over the certify phase's own fresh Latin-hypercube streams, its
    CERT_FRESH scenarios per replication under the same seed, their cuts merged
    into the EF bound model), then the decision polish from the certify
    phase's compromise decision (8192 stratified scenarios, 4 rounds, rho
    20). Gates: every EF at tol 1e-5 and dual infeasibility at most 1e-9;
    the merged bound at least the polish's own and at least the certify
    phase's EF bound of the same streams, and above it in some
    replication (the bundle cuts reach the bound model); lb_cert below
    the certify phase's decision ub + hw; the decision polish's best value
    at most its first and its x first-stage feasible. B1's tile kernel
    and B3 over a leading replication axis must launch. Afterwards B3 is
    held against its plain version at operands the path gave it: the
    R-batched projection QP and the decision polish's master."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.routines import project_first_stage
    from sqlp_tpu_torch.ops import prox_qp
    from sqlp_tpu_torch.sd import lower_bound

    prev = memo.get("certify")
    if prev is None:
        raise AssertionError("cert_polish reuses the certify phase's "
                             "states: run certify before it")
    reps, x_comp, cert_out = prev["reps"], prev["x_comp"], prev["out"]
    fresh = int(cert_out["cert"]["n_scenarios"])
    tag = "[cert_polish]"
    solves = []
    real_solve = lower_bound.solve_batch
    real_admm = prox_qp.admm_round
    taken = {}      # part -> B3 operands of its second interval

    def counted_solve(prep, H, *a, **k):
        # each polish round's one recourse solve: its rows, wall time and
        # tile launches
        torch.cuda.synchronize()
        t, n0 = time.perf_counter(), _counts()["pdhg_halpern_tile"]
        out = real_solve(prep, H, *a, **k)
        torch.cuda.synchronize()
        solves.append((H.shape[0], time.perf_counter() - t,
                       _counts()["pdhg_halpern_tile"] - n0))
        return out

    def taking_admm(part):
        # keeps copies of the operands of the part's second interval that
        # steps all its QPs (8 in the projection, 1 in the decision's)
        def admm(*a):
            nb = a[0].shape[0] if a[0].dim() == 3 else 1
            want = reps.n_replications if part == "projection" else 1
            seen = taken.setdefault(part, [])
            if nb == want and len(seen) < 2:
                seen.append([t.clone() for t in a[:10]] + list(a[10:]))
            return real_admm(*a)
        return admm

    _reset_counts()
    t0 = time.perf_counter()
    lower_bound.solve_batch = counted_solve
    prox_qp.admm_round = taking_admm("projection")
    try:
        cert = reps.certified_lower_bound(method="ef_polish",
                                          polish_rounds=4,
                                          fresh_scenarios=fresh)
        torch.cuda.synchronize()
        ef_s = time.perf_counter() - t0
        counts_ef = _counts()
        rungs_ef = _by_rung()
        prox_qp.admm_round = taking_admm("decision")
        t1 = time.perf_counter()
        x_pol, info = reps.polish_decision(x_comp, n_scenarios=8192,
                                           rounds=4, rho=20.0)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
    finally:
        lower_bound.solve_batch = real_solve
        prox_qp.admm_round = real_admm
    counts = _counts()
    rungs = _by_rung()
    sec = cert["seconds"]
    pol_s = cert["polish_round_seconds"]
    log(f"{tag} ef_polish over {cert['n_scenarios']}-scenario streams in "
        f"{ef_s:.2f}s: polish {sum(pol_s):.2f}s ({cert['polish_rounds']} "
        f"rounds), EF {sec['ef']:.2f}s, f64 refine {sec['refine']:.2f}s, "
        f"projection {sec['projection']:.2f}s, host {sec['host']:.2f}s")
    for i, ((rows, s_, tiles), r_s) in enumerate(zip(solves, pol_s)):
        log(f"{tag} polish round {i + 1}: {rows} rows, recourse solve "
            f"{s_:.2f}s ({tiles} tile launches), round {r_s:.2f}s")
    log(f"{tag} polish launches: {json.dumps(counts_ef)}; by rung: "
        f"{rungs_ef}")
    prev_lb = cert_out["cert"]["lb_per_rep"]
    for k, v in (("lb_per_rep", cert["lb_per_rep"]),
                 ("polish_lb_per_rep", cert["polish_lb_per_rep"]),
                 ("certify_ef_lb_per_rep", prev_lb),
                 ("ef_polish_over_ef", cert["lb_per_rep"] - prev_lb),
                 ("ef_obj_per_rep", cert["ef_obj_per_rep"]),
                 ("ef_err_per_rep", cert["ef_err_per_rep"]),
                 ("dual_infeas_per_rep", cert["dual_infeas_per_rep"])):
        log(f"{tag} {k}: " + " ".join(f"{x:.6g}" for x in v))
    log(f"{tag} lb_cert={cert['lb_cert']:.6f} (mean {cert['lb_mean']:.6f} "
        f"hw {cert['lb_half_width']:.6f}); certify phase: lb_cert="
        f"{cert_out['lb_cert']:.6f}, decision ub {cert_out['ub']:.6f} +- "
        f"{cert_out['ub_hw']:.4f}")
    log(f"{tag} decision polish (8192 scenarios, 4 rounds, rho 20) in "
        f"{dec_s:.2f}s: values {' '.join(f'{v:.6f}' for v in info['values'])}"
        f", serious steps {info['serious_steps']}, f_best "
        f"{info['f_best']:.6f}")
    log(f"{tag} launches: {json.dumps(counts)}")
    log(f"{tag} launches by rung: {rungs}")
    nums = [*cert["lb_per_rep"], *cert["polish_lb_per_rep"],
            cert["lb_cert"], *info["values"], *np.ravel(x_pol)]
    if not all(math.isfinite(float(v)) for v in nums):
        raise AssertionError("non-finite cert_polish numbers")
    if (np.max(cert["ef_err_first_per_rep"]) > CERT_EF_TOL
            or np.max(cert["ef_err_per_rep"]) > CERT_EF_TOL):
        raise AssertionError(f"an EF missed tol {CERT_EF_TOL}")
    if np.max(cert["dual_infeas_per_rep"]) > CERT_DUAL_INFEAS:
        raise AssertionError(f"dual infeasibility above {CERT_DUAL_INFEAS}")
    if np.any(cert["lb_per_rep"] < cert["polish_lb_per_rep"] - 1e-6):
        raise AssertionError("an ef_polish bound below its polish bound")
    if cert["n_scenarios"] != cert_out["cert"]["n_scenarios"]:
        raise AssertionError("ef_polish did not run on the certify phase's "
                             "streams")
    if np.any(cert["lb_per_rep"] < prev_lb - 1e-6):
        raise AssertionError("an ef_polish bound below the certify phase's "
                             "EF bound of the same streams")
    if not np.max(cert["lb_per_rep"] - prev_lb) > 1e-6:
        raise AssertionError("the polish cuts raised no replication's bound "
                             "over the EF route's on the same streams")
    if not cert["lb_cert"] < cert_out["ub"] + cert_out["ub_hw"]:
        raise AssertionError("lb_cert is not below the decision's ub + hw")
    if not info["f_best"] <= info["values"][0]:
        raise AssertionError("the decision polish ended above its start")
    if project_first_stage(reps.inst.arrays, x_pol)[1] > 0.0:
        raise AssertionError("the polished decision is not first-stage "
                             "feasible")
    if counts["admm_round_batched"] <= 0:
        raise AssertionError(f"no batched B3 launch: {counts}")
    _record_launches(results, counts, [
        k for k in ("pdhg_halpern_cluster", "pdhg_halpern_round")
        if counts[k]] + ["pdhg_halpern_tile", "admm_round"], "cert_polish")
    # B3 at the path's own operands (after the counts were read)
    for part in ("projection", "decision"):
        if not taken.get(part):
            raise AssertionError(f"no B3 interval of the {part} QP taken")
        a = taken[part][-1]
        _hold_b3(tag, f"{part} QP", a[:10], tuple(a[10:]))


def phase_polish_witness(memo, n_reps=2, scenarios=64, rounds=4):
    """A second witness of the level bundle on the certify phase's ssn
    states: ``saa_polish`` over its first ``n_reps`` replications with
    ``scenarios`` fresh scenarios each and ``rounds`` rounds, once on the
    card and once on the host through the plain versions (the instance,
    the states and the drawn streams copied to the CPU), in the run's
    float32. Prints both runs' round-1 cuts (the incumbents': no QP has
    run yet) apart and their bounds; fails on a non-finite bound or one
    above its SAA value estimate."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd import lower_bound
    from sqlp_tpu_torch.sd.driver import SDSolver
    from sqlp_tpu_torch.sd.state import state_from_numpy, state_to_numpy

    prev = memo.get("certify")
    if prev is None:
        raise AssertionError("polish_witness reads the certify phase's "
                             "states: run certify before it")
    reps = prev["reps"]
    cfg = reps.config
    cpu = SDSolver(load_instance(reps.inst.name, dtype=cfg.jdtype,
                                 device="cpu"),
                   cfg, x0=np.zeros(reps.inst.n1), seed=0)
    on_card = reps.states[:n_reps]
    on_cpu = [state_from_numpy(state_to_numpy(st), cpu.state)
              for st in on_card]
    real = lower_bound._certification_streams
    drawn = []

    def streams(*a, **k):
        if not drawn:
            drawn.append(real(*a, **k))
        return drawn[0]

    out = {}
    lower_bound._certification_streams = streams
    try:
        for where, s, states in (("card", reps, on_card),
                                 ("host", cpu, on_cpu)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[where] = lower_bound.saa_polish(
                s.arrays, s.scenario_model, s.espec, s.prep_sub, states,
                s.config, obj_scale=s.obj_scale, max_rounds=rounds,
                fresh_scenarios=scenarios)
            torch.cuda.synchronize()
            log(f"[polish_witness] {where}: {n_reps} x {scenarios} "
                f"scenarios, {out[where]['rounds']} rounds in "
                f"{time.perf_counter() - t0:.2f}s: lb_per_rep "
                + " ".join(f"{v:.6f}" for v in out[where]["lb_per_rep"])
                + "; saa_ub_per_rep " + " ".join(
                    f"{v:.6f}" for v in out[where]["saa_ub_per_rep"]))
    finally:
        lower_bound._certification_streams = real
    for r in range(n_reps):
        (_, a_c, b_c), (_, a_h, b_h) = (out["card"]["cuts_per_rep"][r][0],
                                        out["host"]["cuts_per_rep"][r][0])
        log(f"[polish_witness] replication {r} round-1 cut: alpha "
            f"{a_c:.6f} (card) {a_h:.6f} (host), beta apart by "
            f"{np.abs(b_c - b_h).max():.3e} of {np.abs(b_h).max():.3e}")
    for where, o in out.items():
        lbs, ubs = o["lb_per_rep"], o["saa_ub_per_rep"]
        if not np.all(np.isfinite(lbs)) or np.any(lbs > ubs + 1e-6):
            raise AssertionError(f"{where} polish bounds {lbs} not finite "
                                 f"or above their SAA values {ubs}")


_STARTED = []     # every CLI subprocess this script starts


# a CLI run that ends by printing its process's kernel launches (every
# count starts at 0 in a fresh process) on a line of its standard error
_COUNTED = ("import json, sys, chip_smoke\n"
            "from sqlp_tpu_torch.cli import main\n"
            "rc = main(sys.argv[1:])\n"
            "print('chip_smoke launches: ' + json.dumps(chip_smoke._counts()),"
            " file=sys.stderr)\n"
            "sys.exit(rc)\n")


def _cli(args, counted=False, env=None, code=None):
    """Start a CLI subprocess of the port from the repo root, its output
    into temporary files (pipes could fill while another run is waited
    for); returns (process, stdout file, stderr file). ``counted`` runs
    it through ``_COUNTED``, ``code`` runs ``python -c code args``."""
    import tempfile
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    head = ["-c", code] if code else \
        ["-c", _COUNTED] if counted else ["-m", "sqlp_tpu_torch"]
    proc = subprocess.Popen(
        [sys.executable, *head, *args], stdout=out,
        stderr=err, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    _STARTED.append(proc)
    return proc, out, err


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _read(f) -> str:
    f.seek(0)
    text = f.read()
    f.close()
    return text


def _start(tag, runs, counted=False, after=None):
    """Start a phase's CLI runs ({name: arguments}); ``after`` ({name:
    (next name, arguments)}) starts a run as soon as the named one has
    ended. Returns the function that waits for them, logs each result line
    and returns {name: (stdout, stderr)}, or raises when a run failed."""
    import threading
    t0 = time.perf_counter()
    # as it is now, also for the chained runs; one intra-op thread a
    # process, as a dozen CLI processes share the host's eight cores
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = {k: _cli(v, counted, env) for k, v in runs.items()}
    chained = []
    for first, (name, args) in (after or {}).items():
        def chain(first=first, name=name, args=args):
            procs[first][0].wait()
            procs[name] = _cli(args, counted, env)
        chained.append(threading.Thread(target=chain))
        chained[-1].start()
        runs = dict(runs, **{name: args})

    def wait():
        for t in chained:
            t.join()
        outs = {k: (p.wait(), _read(o), _read(e))
                for k, (p, o, e) in procs.items()}
        failed = []
        for k, (rc, out, err) in outs.items():
            lines = [ln for ln in out.splitlines()
                     if ln.startswith(("lb_", "cert_gap", "objective",
                                       "mc_ub", "decision"))]
            log(f"[{tag}] {' '.join(runs[k])}: rc={rc} "
                f"{' | '.join(lines) if rc == 0 else err[-2000:]}")
            if rc != 0:
                failed.append(k)
        log(f"[{tag}] runs ended {time.perf_counter() - t0:.1f}s after "
            f"their start")
        if failed:
            raise AssertionError(f"[{tag}] lands CLI runs failed: {failed}")
        return {k: (out, err) for k, (_, out, err) in outs.items()}
    return wait


def _lands_saa_optimum(n, seed):
    """The exact optimum (host HiGHS, f64) of the lands extensive form over
    the n scenarios that ``python -m sqlp_tpu_torch ef lands --scenarios n
    --seed seed --device cuda`` draws: the same generator on the same card,
    the same model in float32. Only the drawn deltas come from the port;
    the scenarios' right-hand sides and transfer rows are built here in
    numpy from the instance's arrays."""
    import numpy as np
    import torch
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.models.routines import solve_lp_host
    from sqlp_tpu_torch.models.scenario import sample_deltas

    dev = torch.device("cuda")
    inst = load_instance("lands", dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = sample_deltas(gen, inst.scenario_model, n).double().cpu().numpy()
    a = {k: getattr(inst.arrays, k).cpu().numpy().astype(
        np.float64 if k[:6] != "senses" else np.int64) for k in (
        "c", "A1", "b1", "senses1", "lb1", "ub1", "q", "W", "T", "r",
        "senses2", "lb2", "ub2")}
    sm = {k: getattr(inst.scenario_model, k).cpu().numpy()
          for k in ("rv_row", "rv_col", "rv_is_rhs", "rv_is_cost")}
    if sm["rv_is_cost"].any():
        raise AssertionError("lands has no random costs")
    rhs, tr = sm["rv_is_rhs"], ~sm["rv_is_rhs"]
    m1, n1 = a["A1"].shape
    m2, n2 = a["W"].shape
    A = np.zeros((m1 + n * m2, n1 + n * n2))
    A[:m1, :n1] = a["A1"]
    b = [a["b1"]]
    for k in range(n):
        rows = slice(m1 + k * m2, m1 + (k + 1) * m2)
        Tk = a["T"].copy()
        np.add.at(Tk, (sm["rv_row"][tr], sm["rv_col"][tr]), d[k, tr])
        rk = a["r"].copy()
        np.add.at(rk, sm["rv_row"][rhs], d[k, rhs])
        A[rows, :n1] = Tk
        A[rows, n1 + k * n2:n1 + (k + 1) * n2] = a["W"]
        b.append(rk)
    obj, _, _ = solve_lp_host(
        np.concatenate([a["c"], np.tile(a["q"] / n, n)]), A,
        np.concatenate(b),
        np.concatenate([a["senses1"], np.tile(a["senses2"], n)]),
        np.concatenate([a["lb1"], np.tile(a["lb2"], n)]),
        np.concatenate([a["ub1"], np.tile(a["ub2"], n)]))
    return obj


# SD iterations of the lands CLI runs of `cli` and `cli_cert`: 200 until
# the script outgrew its 1200 s (after 100 on the card, lands from the
# uniform proposal had both bounds within 1.2 of the optimum; the gates
# allow 6)
LANDS_CLI_ITERS = 100


def start_cli_cert():
    """The lands CLI on the certified path, three processes at once:
    solve --replications 3 --certify (the compromise's bound and lb_cert
    within 6 of the optimum, lb_cert below the decision's ub + hw; the
    replicated solve and its compromise are the run's first part), ef
    over 100 scenarios (converged, its
    objective at the exact optimum of the same 100 scenarios: a
    100-scenario sample's own optimum lies several units from the true
    381.8533, 388.23 in the reference's `ef lands` at seed 0), and solve
    --x0 crash (lb and ub within 6)."""
    wait = _start("cli_cert", {
        "certify": ["solve", "lands", "--replications", "3", "--iters",
                    str(LANDS_CLI_ITERS), "--certify", "--eval-samples",
                    "4096", "--device", "cuda"],
        "ef": ["ef", "lands", "--scenarios", "100", "--device", "cuda"],
        "crash": ["solve", "lands", "--x0", "crash", "--iters",
                  str(LANDS_CLI_ITERS), "--eval-samples", "4096", "--device",
                  "cuda"]})

    def finish():
        outs = wait()
        out = outs["certify"][0]
        m = re.search(r"mc_ub_compromise=(\S+) mc_ub_average=(\S+)", out)
        if m is None:
            raise AssertionError("lands replicated CLI run printed no bound")
        if not abs(float(m.group(1)) - LANDS_OPT) < 6.0:
            raise AssertionError(f"lands compromise bound {m.group(1)} not "
                                 f"within 6 of {LANDS_OPT}")
        m = re.search(r"lb_cert=(\S+) ", out)
        u = re.search(r"cert_gap=\S+ \(ub (\S+)\+-(\S+),", out)
        if not (m and u):
            raise AssertionError("lands --certify printed no lb_cert / "
                                 "cert_gap")
        lb_cert = float(m.group(1))
        ub, hw = float(u.group(1)), float(u.group(2))
        if not (abs(lb_cert - LANDS_OPT) < 6.0 and lb_cert < ub + hw):
            raise AssertionError(f"lands lb_cert {lb_cert} not within 6 of "
                                 f"{LANDS_OPT} or not below ub + hw "
                                 f"{ub + hw}")
        out, err = outs["ef"]
        m = re.search(r"objective=(\S+)", out)
        exact = _lands_saa_optimum(100, seed=0)
        log(f"[cli_cert] the 100 scenarios' exact EF optimum (HiGHS): "
            f"{exact:.6f} ({exact - LANDS_OPT:+.4f} from {LANDS_OPT})")
        if not (m and "converged=True" in err
                and abs(float(m.group(1)) - exact) <= 1e-3 * abs(exact)):
            raise AssertionError("lands EF not converged to its exact "
                                 "optimum")
        m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", outs["crash"][0])
        if not (m and all(abs(float(v) - LANDS_OPT) < 6.0
                          for v in m.groups())):
            raise AssertionError("lands from the crash start not within 6")
    return finish


def start_cli():
    # 4096 MC samples keep the upper bound's sampling half-width (about 2
    # on lands) well inside the 6-unit band
    wait = _start("cli", {"solve": [
        "solve", "lands", "--iters", str(LANDS_CLI_ITERS), "--device", "cuda",
        "--eval-samples", "4096"]})

    def finish():
        m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", wait()["solve"][0])
        if m is None:
            raise AssertionError("lands CLI run printed no bounds")
        lb, ub = float(m.group(1)), float(m.group(2))
        if abs(lb - LANDS_OPT) >= 6.0 or abs(ub - LANDS_OPT) >= 6.0:
            raise AssertionError(f"lands bounds lb={lb} ub={ub} not within "
                                 f"6 of {LANDS_OPT}")
    return finish


def start_cli_gap(results):
    """The certified-gap stopping run and the periodic loop, two processes
    at once, each counting its kernel launches: the reference bench's
    lands_target_gap at its on-chip settings (bench.py:361-382; stopped
    with cert_gap <= 0.01 at one of its 2 looks), and ssn at the flagship
    settings for GAP_SSN_ITERS iterations with the Monte-Carlo bound and
    host dual sharpening every GAP_SSN_ITERS / 2 (one sharpening, halfway:
    none at the final iteration; mc_ub halfway and at the end; lb_est
    below mc_ub + hw)."""
    half = GAP_SSN_ITERS // 2
    wait = _start("cli_gap", {
        "lands": ["solve", "lands", "--replications", "4", "--iters", "400",
                  "--target-gap", "0.01", "--certify-every", "200",
                  "--certify-scenarios", "1024", "--eval-samples", "8192",
                  "--device", "cuda"],
        "ssn": ["solve", "ssn", "--iters", str(GAP_SSN_ITERS), "--schedule",
                "adaptive", "--rho", "1e-3", "--eval-every", str(half),
                "--sharpen-every", str(half), "--sharpen-k", "32",
                "--device", "cuda"]},
        counted=True)

    def finish():
        outs = wait()
        out, err = outs["lands"]
        rec = json.loads(out.strip().splitlines()[-1])
        for line in err.splitlines():
            if line.startswith("[certify]"):
                log(f"[cli_gap] lands {line}")
        log(f"[cli_gap] lands: stopped={rec['stopped']} iters="
            f"{rec['iters']} route={rec['route']} cert_gap="
            f"{rec['cert_gap']:.5f} looks={rec['looks']} lb_cert="
            f"{rec['lb_cert']:.6f} ub={rec['compromise_mc_ub']:.6f} +- "
            f"{rec['compromise_mc_ub_half_width']:.4f} ("
            f"{rec['mc_ub_samples']} samples) time_to_certified_gap_s="
            f"{rec['time_to_certified_gap_s']}")
        if not (rec["stopped"] and rec["cert_gap"] <= 0.01
                and rec["looks"] == 2):
            raise AssertionError(f"lands --target-gap 0.01 did not stop at "
                                 f"a certified gap <= 0.01 in 2 looks: {rec}")
        out, err = outs["ssn"]
        sharpened = re.findall(r"iter (\d+): sharpened (.*)", err)
        evals = re.findall(r"iter (\d+): mc_ub=(\S+) \(\+-(\S+)\)", err)
        for it, rest in sharpened:
            log(f"[cli_gap] ssn iter {it}: sharpened {rest}")
        for it, ub, hw in evals:
            log(f"[cli_gap] ssn iter {it}: mc_ub={ub} +- {hw}")
        m = re.search(r"lb_est=(\S+) mc_ub=(\S+) \(95% \+- (\S+),", out)
        if not m:
            raise AssertionError("ssn periodic run printed no bounds")
        lb, ub, hw = map(float, m.groups())
        if [int(it) for it, _ in sharpened] != [half]:
            raise AssertionError(f"ssn sharpened at {sharpened}, not once at "
                                 f"iteration {half}")
        if [int(it) for it, _, _ in evals] != [half, GAP_SSN_ITERS]:
            raise AssertionError(f"ssn evaluated at {evals}, not at {half} "
                                 f"and {GAP_SSN_ITERS}")
        if not lb <= ub + hw:
            raise AssertionError(f"ssn lb_est {lb} above mc_ub + hw "
                                 f"{ub + hw}")
        for name, (out, err) in outs.items():
            m = re.search(r"chip_smoke launches: (\{.*\})", err)
            if m is None:
                raise AssertionError(f"cli_gap {name}: no launch counts")
            counts = json.loads(m.group(1))
            log(f"[cli_gap] {name} launches: {json.dumps(counts)}")
            b1 = [k for k in ("pdhg_halpern_round", "pdhg_halpern_cluster",
                              "pdhg_halpern_tile", "pdhg_halpern_small")
                  if counts[k]]
            if not b1:
                raise AssertionError(f"cli_gap {name}: B1 never launched")
            _record_launches(results, counts, b1 + ["admm_round"],
                             f"cli_gap_{name}")
    return finish


# iterations of cli_gap's periodic ssn run and of cli_run's uninterrupted
# ssn run (the resumed one runs half, then half again), each cut from 200
# to 100 when the storm phase took the default script near its 1200 s,
# then to 60 when it outgrew them, then to 40 when the small kernels'
# cases took it past 1000 s on a slow host
GAP_SSN_ITERS = 40
RESUME_ITERS = 40
# iterations of cli_run's lands importance-sampling run, 200 in the
# reference's test (tests/test_sampling.py:270-295) and here until the
# script outgrew its 1200 s
IS_LANDS_ITERS = 100
# iterations of cli_run's ssn importance-sampling run, cut from 200: under
# the profiler every eager operator is an event, 19 MB of trace an ssn
# iteration (3.9 GB at 200); then from 100 to 50 when the mesh phase took
# the default script past 1100 of its 1200 s, and to 20 when the storm
# phase did
IS_ITERS = 20
# the uniform proposal over lands' support (tests/test_sampling.py:278-285)
LANDS_UNIFORM = ("STOCH         LandS\n"
                 "INDEP         DISCRETE\n"
                 "    RHS       S2C5      3.0       0.3333333333\n"
                 "    RHS       S2C5      5.0       0.3333333333\n"
                 "    RHS       S2C5      7.0       0.3333333334\n"
                 "ENDATA\n")


def _write_defensive_proposal(path):
    """ssn's own positions and values, each position's pmf p replaced by
    q = 0.9 p + 0.1 / n over its n outcomes: a defensive mixture, so each
    position's ratio p / q is at most 1 / 0.9."""
    from sqlp_tpu_torch.models.instance import find_instance_dir
    from sqlp_tpu_torch.models.smps_sto import read_sto_py
    sto = read_sto_py(os.path.join(find_instance_dir("ssn"), "ssn.sto"))
    lines = [f"STOCH         {sto.problem_name}", "INDEP         DISCRETE"]
    for pos, d in sto.indep.items():
        p = [v / sum(d.probability) for v in d.probability]
        for v, pk in zip(d.value, p):
            lines.append(f"    {pos.col_name}    {pos.row_name}    {v!r}    "
                         f"{0.9 * pk + 0.1 / len(p)!r}")
    lines.append("ENDATA")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def _trace_kernels(log_dir, needles):
    """(file, size in bytes, {needle: the first CUDA kernel name that
    holds it, or None}) of the one Chrome trace that ``--profile`` wrote
    into log_dir. The trace runs to gigabytes, so it is searched as bytes
    (a kernel event's lines: ``"cat": "kernel",`` then ``"name":
    "...",``) instead of parsed."""
    import glob
    import mmap
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile {log_dir} wrote {files}, not one "
                             f"trace")
    event = re.compile(rb'"cat": "kernel",\s*"name": "([^"]*)$')
    found = {}
    with open(files[0], "rb") as fh, \
            mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) as m:
        for needle in needles:
            found[needle] = None
            at = m.find(needle.encode())
            while at >= 0 and found[needle] is None:
                hit = event.search(m[max(0, at - 512):at])
                if hit:
                    end = m.find(b'"', at)
                    found[needle] = (hit.group(1) + m[at:end]).decode()
                at = m.find(needle.encode(), at + 1)
    return files[0], os.path.getsize(files[0]), found


def _parse_equal():
    """The native and the Python parsers (``SQLP_TPU_TORCH_NATIVE=0``) on
    ssn and storm: the parsed files and the instances compiled from them
    on the card equal field by field; returns {name: (native parse s,
    Python parse s)}."""
    import torch
    from sqlp_tpu_torch.models.instance import (ARRAY_FIELDS,
                                                find_instance_dir,
                                                load_instance)
    from sqlp_tpu_torch.models.scenario import SCENARIO_FIELDS
    from sqlp_tpu_torch.models.smps_cor import read_cor
    from sqlp_tpu_torch.models.smps_sto import read_sto

    times = {}
    for name in ("ssn", "storm"):
        base = os.path.join(find_instance_dir(name), name)
        loaded = {}
        try:
            for mode in ("1", "0"):
                os.environ["SQLP_TPU_TORCH_NATIVE"] = mode
                t0 = time.perf_counter()
                read_cor(base + ".cor")
                read_sto(base + ".sto")
                loaded[mode + "s"] = time.perf_counter() - t0
                loaded[mode] = load_instance(name, dtype=torch.float32,
                                             device="cuda")
        finally:
            os.environ.pop("SQLP_TPU_TORCH_NATIVE", None)
        a, b = loaded["1"], loaded["0"]
        bad = [f for f in ARRAY_FIELDS
               if not torch.equal(getattr(a.arrays, f), getattr(b.arrays, f))]
        bad += [f for f in SCENARIO_FIELDS
                if not torch.equal(getattr(a.scenario_model, f),
                                   getattr(b.scenario_model, f))]
        if bad or a.cor.row_names != b.cor.row_names \
                or list(a.sto.indep) != list(b.sto.indep):
            raise AssertionError(f"{name}: the native and the Python parsers "
                                 f"compile different instances: {bad}")
        times[name] = (loaded["1s"], loaded["0s"])
    return times


def start_cli_run(results):
    """Run management and importance sampling through the CLI on the
    card, five processes beside the other CLI phases, each counting its
    kernel launches:
    (a) resume on ssn at the flagship settings, capacities fixed at the
        autoscaled values for RESUME_ITERS iterations: U runs RESUME_ITERS
        iterations with a checkpoint and a JSONL log every quarter; A runs
        half with a checkpoint; B, started when A ends, resumes A's file
        for the other half.
        B's checkpoint equals U's bit for bit (every state field and the
        generator's state), and so do the final lb_est and mc_ub; U's log
        holds 4 period records and one final record;
    (b) ssn drawn from a defensive mixture proposal (written here from
        ssn.sto) for IS_ITERS iterations under --profile: bounds finite,
        stored weights positive and finite, total_weight their sum, the
        weights' effective sample size printed, and the trace names B1's
        cluster kernel and B3's kernel;
    (c) lands from the uniform proposal, IS_LANDS_ITERS iterations:
        stored weights in {0.9, 1.2}, total_weight / IS_LANDS_ITERS within
        0.15 of 1, mc_ub within 6 of 381.8533 (tests/test_sampling.py:
        266-295);
    (d) here, while they run: ssn and storm through the native and the
        Python parsers compile equal instances; both parse times
        printed."""
    import tempfile
    from sqlp_tpu_torch.config import SDConfig, autoscale_capacities

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_run_")

    def at(name):
        return os.path.join(tmp, name)

    cfg = autoscale_capacities(SDConfig(max_scenarios=4096,
                                        max_dual_vertices=2048),
                               RESUME_ITERS)
    ssn = ["solve", "ssn", "--schedule", "adaptive", "--rho", "1e-3",
           "--seed", "0", "--device", "cuda", "--no-auto-capacity",
           "--max-scenarios", str(cfg.max_scenarios),
           "--max-duals", str(cfg.max_dual_vertices)]
    _write_defensive_proposal(at("ssn_proposal.sto"))
    with open(at("lands_proposal.sto"), "w") as fh:
        fh.write(LANDS_UNIFORM)
    half = str(RESUME_ITERS // 2)
    resume = ssn + ["--iters", half, "--resume", at("A.npz"),
                    "--checkpoint", at("B.npz")]
    wait = _start("cli_run", {
        "U": ssn + ["--iters", str(RESUME_ITERS), "--checkpoint",
                    at("U.npz"), "--log", at("U.jsonl"), "--log-every",
                    str(RESUME_ITERS // 4)],
        "A": ssn + ["--iters", half, "--checkpoint", at("A.npz")],
        "is_ssn": ssn + ["--iters", str(IS_ITERS), "--proposal-sto",
                         at("ssn_proposal.sto"), "--checkpoint",
                         at("is_ssn.npz"), "--profile", at("profile")],
        "is_lands": ["solve", "lands", "--iters", str(IS_LANDS_ITERS),
                     "--proposal-sto",
                     at("lands_proposal.sto"), "--checkpoint",
                     at("is_lands.npz"), "--eval-samples", "4096",
                     "--device", "cuda"]}, counted=True,
        after={"A": ("B", resume)})
    t0 = time.perf_counter()
    for name, (native_s, python_s) in _parse_equal().items():
        log(f"[cli_run] {name}: native and Python parsers compile equal "
            f"instances; .cor + .sto parsed in {native_s:.4f}s native, "
            f"{python_s:.4f}s Python")
    log(f"[cli_run] parser check {time.perf_counter() - t0:.1f}s")

    def fields(name):
        import numpy as np
        with np.load(at(name)) as z:
            return {k: z[k] for k in z.files}

    def bounds(out):
        m = re.search(r"lb_est=(\S+) mc_ub=(\S+) \(95% \+- (\S+),", out)
        if m is None:
            raise AssertionError("a cli_run run printed no bounds")
        return m.groups()

    def finish():
        import shutil
        try:
            check(wait())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def check(outs):
        import numpy as np
        for name, (_, err) in outs.items():
            done = re.findall(r"done: .*", err)
            log(f"[cli_run] {name}: {done[-1] if done else 'no done line'}")
        # (a) the resumed run against the uninterrupted one
        fu, fb = fields("U.npz"), fields("B.npz")
        diff = sorted(k for k in set(fu) | set(fb) if k not in fu
                      or k not in fb or fu[k].dtype != fb[k].dtype
                      or not np.array_equal(fu[k], fb[k]))
        bu, bb = bounds(outs["U"][0]), bounds(outs["B"][0])
        recs = [json.loads(line) for line in open(at("U.jsonl"))]
        log(f"[cli_run] resume: B.npz against U.npz, {len(fu)} entries "
            f"(torch_generator_state among them: "
            f"{'torch_generator_state' in fu}), differing: {diff}; "
            f"U lb_est={bu[0]} mc_ub={bu[1]}, B lb_est={bb[0]} "
            f"mc_ub={bb[1]}; U.jsonl its {[r['it'] for r in recs]}")
        if diff or "torch_generator_state" not in fu:
            raise AssertionError(f"resumed ssn run not bitwise: {diff}")
        if bu[:2] != bb[:2]:
            raise AssertionError(f"resumed ssn bounds {bb} != {bu}")
        if [r.get("final", False) for r in recs] != [False] * 4 + [True]:
            raise AssertionError(f"U.jsonl holds {recs}")
        # (b) ssn from the defensive proposal
        lb, ub, hw = map(float, bounds(outs["is_ssn"][0]))
        f = fields("is_ssn.npz")
        n = int(f["n_scen"][0])
        w = f["scen_weights"][0, :n].astype(np.float64)
        ess = w.sum() ** 2 / np.sum(w * w)
        tw = float(f["total_weight"][0])
        trace, size, found = _trace_kernels(
            at("profile"), ("pdhg_cluster_kernel<float, false",
                            "admm_cluster_kernel<"))
        b1, b3 = found.values()
        log(f"[cli_run] ssn importance sampling ({IS_ITERS} iterations): "
            f"lb_est={lb:.6f} mc_ub={ub:.6f} +- {hw:.4f}; {n} stored "
            f"weights in [{w.min():.6g}, {w.max():.6g}], sum {w.sum():.6f}, "
            f"total_weight {tw:.6f}, ESS {ess:.2f} of {n}")
        log(f"[cli_run] trace {os.path.basename(trace)}: {size} bytes; "
            f"B1 cluster {b1!r}; B3 {b3!r}")
        if not (math.isfinite(lb) and math.isfinite(ub)):
            raise AssertionError(f"ssn importance-sampling bounds {lb} {ub}")
        if n != int(f["n_stream"][0]) or not np.all(np.isfinite(w)) \
                or not np.all(w > 0.0) \
                or abs(tw - w.sum()) > 1e-5 * w.sum():
            raise AssertionError(f"ssn stored weights do not sum to "
                                 f"total_weight {tw}: {w}")
        if not (b1 and b3):
            raise AssertionError(f"the ssn trace names no B1 cluster or no "
                                 f"B3 kernel: {found}")
        # (c) lands from the uniform proposal
        _, ub, _ = map(float, bounds(outs["is_lands"][0]))
        f = fields("is_lands.npz")
        w = f["scen_weights"][0, :int(f["n_scen"][0])]
        ratio = float(f["total_weight"][0]) / IS_LANDS_ITERS
        log(f"[cli_run] lands importance sampling: weights "
            f"{sorted(set(np.round(w.astype(np.float64), 6).tolist()))}, "
            f"total_weight / {IS_LANDS_ITERS} = {ratio:.6f}, "
            f"mc_ub={ub:.6f}")
        if not (set(np.round(w.astype(np.float64), 6)) <= {0.9, 1.2}
                and abs(ratio - 1.0) < 0.15
                and abs(ub - LANDS_OPT) < 6.0):
            raise AssertionError("lands importance sampling missed the "
                                 "reference's gates")
        for name, (out, err) in outs.items():
            counts = json.loads(re.findall(r"chip_smoke launches: (\{.*\})",
                                           err)[-1])
            log(f"[cli_run] {name} launches: {json.dumps(counts)}")
            b1 = [k for k in ("pdhg_halpern_round", "pdhg_halpern_cluster",
                              "pdhg_halpern_tile", "pdhg_halpern_small")
                  if counts[k]]
            if not b1:
                raise AssertionError(f"cli_run {name}: B1 never launched")
            _record_launches(results, counts, b1 + ["admm_round"],
                             f"cli_run_{name}")
    return finish


# the bench phase's depths of the sections it calls in this process
# (sqlp_tpu_torch/bench.py:run_section's arguments): the reference bench's
# workloads cut to the fewest iterations that drive each section's glue on
# the card, as the script has no room (with 20, 10, 2 x 10 and 40
# iterations here the default script took 1259.3 s on an H100 whose host
# ran the main path at 4.15 it/s). storm_certified's 8192 samples are one
# panel of evaluate_ci(batch=8192), the shape its full depth gives the
# grid kernel. ssn_certified (R 2 x 20, 256 fresh scenarios: 67.7 s on an
# H100, most of it the EF at tol 1e-5) runs in bench_full only
BENCH_SMOKE = {
    "ssn_time_to_gap": {"n_iters": 5},
    "storm_time_to_gap": {"n_iters": 3},
    "storm_certified": {"n_reps": 2, "n_iters": 3, "method": "model",
                        "ub_samples": 8192, "ub_half_width": 0.0},
    "lands_target_gap": {"max_iters": 10, "certify_every": 10,
                         "min_ub_samples": 2048, "max_ub_samples": 2048,
                         "fresh_scenarios": 256},
}
# the keys of the reference bench's dicts (bench.py:207-209, 240-247,
# 329-358; lands: SDReplications.solve_to_certified_gap's record less
# x_compromise and rounds, bench.py:361-381) and of its last object under
# --skip-sd-gap (:409-418)
BENCH_KEYS = {
    "throughput": ("throughput", "baseline", "baseline_runs", "batch",
                   "max_rel_err_vs_highs"),
    "sd_gap": ("sd_iters", "sd_wallclock_s", "sd_iters_per_sec", "gap_kind",
               "lb_est", "lb_est_mean_last100", "mc_ub", "mc_ub_half_width",
               "rel_gap"),
    "certified": ("n_replications", "sd_iters", "cert_method", "decision",
                  "decision_selection", "n_cert_scenarios", "sd_wall_s",
                  "cert_wall_s", "ub_wall_s", "total_wall_s", "lb_cert",
                  "lb_mean", "lb_half_width", "lb_per_rep_min",
                  "lb_per_rep_max", "ef_err_max", "dual_infeas_max",
                  "confidence", "decision_mc_ub",
                  "decision_mc_ub_half_width", "mc_ub_samples",
                  "host_fallback_count", "cert_gap"),
    "lands_target_gap": ("it", "route", "wall_s", "lb_cert", "lb_mean",
                         "lb_half_width", "compromise_mc_ub",
                         "compromise_mc_ub_half_width", "mc_ub_samples",
                         "cert_gap", "stopped", "iters", "target_gap",
                         "confidence", "time_to_certified_gap_s"),
    "final": ("metric", "value", "unit", "vs_baseline", "backend", "batch",
              "serial_baseline_lp_per_sec", "serial_baseline_runs"),
}
# a section's kind of dict, and the kernels its path must launch
_BENCH_KIND = {"ssn_time_to_gap": "sd_gap", "storm_time_to_gap": "sd_gap",
               "storm_certified": "certified", "ssn_certified": "certified",
               "lands_target_gap": "lands_target_gap",
               "throughput": "throughput"}
_BENCH_KERNELS = {
    "throughput": ("pdhg_halpern_tile",),
    "ssn_time_to_gap": ("pdhg_halpern_cluster", "pdhg_halpern_tile",
                        "admm_round"),
    "storm_time_to_gap": ("pdhg_halpern_cluster", "pdhg_halpern_grid",
                          "admm_round"),
    "storm_certified": ("pdhg_halpern_grid", "admm_round"),
    "ssn_certified": ("pdhg_halpern_cluster", "pdhg_halpern_tile",
                      "admm_round"),
    "lands_target_gap": ("pdhg_halpern_small", "admm_round"),
}
# a kind's numbers that must be finite, and its (lower bound, upper bound,
# half-width), the lower at most the upper plus the half-width
_BENCH_BOUNDS = {
    "throughput": (("throughput", "baseline"), None),
    "sd_gap": (("lb_est", "lb_est_mean_last100", "mc_ub",
                "mc_ub_half_width"), None),
    "certified": (("lb_cert", "lb_mean", "lb_half_width", "decision_mc_ub",
                   "decision_mc_ub_half_width"),
                  ("lb_cert", "decision_mc_ub", "decision_mc_ub_half_width")),
    "lands_target_gap": (("lb_cert", "lb_mean", "lb_half_width",
                          "compromise_mc_ub", "compromise_mc_ub_half_width"),
                         ("lb_cert", "compromise_mc_ub",
                          "compromise_mc_ub_half_width")),
}


def _bench_gates(tag, name, rec):
    """A section's gates: the reference's keys, its numbers finite, its
    lower bound at most its upper bound + half-width; the throughput's
    rates positive and its HiGHS spot check below 1e-3."""
    kind = _BENCH_KIND[name]
    missing = [k for k in BENCH_KEYS[kind] if k not in rec]
    if missing:
        raise AssertionError(f"[{tag}] {name} lacks the reference's keys "
                             f"{missing}: {rec}")
    finite, order = _BENCH_BOUNDS[kind]
    ok = all(math.isfinite(rec[k]) for k in finite)
    if order:
        lo, ub, hw = (rec[k] for k in order)
        ok = ok and lo <= ub + hw
    if kind == "throughput":
        ok = ok and rec["throughput"] > 0.0 and rec["baseline"] > 0.0 \
            and rec["max_rel_err_vs_highs"] < 1e-3
    if not ok:
        raise AssertionError(f"[{tag}] {name} fails its gates: {rec}")


def _bench_section(results, name, depth, instances, path):
    """One section through sqlp_tpu_torch.bench.run_section inside a
    reset-and-read window of the launch counts: its line, its launches
    (also by rung), its gates (_bench_gates) and its kernels launched."""
    import torch
    from sqlp_tpu_torch import bench as pb

    _reset_counts()
    t0 = time.perf_counter()
    rec = pb.run_section(name, torch.device("cuda"), depth, instances)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _counts()
    log(json.dumps({"section": name, **rec}))
    log(f"[{path}] {name} in {sec:.1f}s; launches: {json.dumps(counts)}")
    log(f"[{path}] {name} launches by rung: {_by_rung()}")
    _bench_gates(path, name, rec)
    _record_launches(results, counts, _BENCH_KERNELS[name],
                     f"{path}_{name}")
    return rec


def _others_beside(tag):
    """Log the script's own subprocesses still running beside a phase."""
    running = [p.pid for p in _STARTED if p.poll() is None]
    log(f"[{tag}] other processes of this script beside it: "
        f"{running if running else 'none'}")
    return running


def phase_bench(results):
    """The reference bench's sections through the port's module, with no
    other process of the script on the card.
    (a) The entry point at the reference's depth: ``python -m
        sqlp_tpu_torch bench --skip-sd-gap`` (ssn at B = 4096, the HiGHS
        spot check on every 1024th row, 5 x 16 serial host LPs), counting
        its launches: rc 0, exactly two JSON lines (the section, then the
        reference's object with its keys), the section's gates
        (_bench_gates: max_rel_err_vs_highs < 1e-3, throughput and
        baseline positive and finite), B1's tile kernel launched.
    (b) The glue on the card: four other sections in this process at
        BENCH_SMOKE's depths, each in a window of its own: the reference's
        keys, every bound finite, each lower bound at most its upper bound
        + half-width, the kernels of _BENCH_KERNELS launched
        (storm_certified: the grid kernel at 8192 rows)."""
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel as pk

    t0 = time.perf_counter()
    _others_beside("bench")
    proc, out, err = _cli(["bench", "--skip-sd-gap"], counted=True)
    rc = proc.wait()
    out, err = _read(out), _read(err)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    log(f"[bench] python -m sqlp_tpu_torch bench --skip-sd-gap: rc={rc} in "
        f"{time.perf_counter() - t0:.1f}s")
    for ln in lines:
        log(ln)
    if rc != 0 or len(lines) != 2:
        raise AssertionError(f"[bench] the CLI gave rc {rc} and {len(lines)} "
                             f"JSON lines (want 0 and 2): {err[-2000:]}")
    sec, final = map(json.loads, lines)
    m = re.search(r"chip_smoke launches: (\{.*\})", err)
    if m is None:
        raise AssertionError("[bench] the CLI printed no launch counts")
    counts = json.loads(m.group(1))
    log(f"[bench] throughput launches: {json.dumps(counts)}")
    missing = [k for k in BENCH_KEYS["final"] if k not in final]
    if sec.pop("section", None) != "throughput" or missing:
        raise AssertionError(f"[bench] the CLI's lines {lines} (the last "
                             f"lacks {missing})")
    _bench_gates("bench", "throughput", sec)
    _record_launches(results, counts, _BENCH_KERNELS["throughput"],
                     "bench_throughput")

    instances = {}
    for name in BENCH_SMOKE:
        _bench_section(results, name, BENCH_SMOKE, instances, "bench")
        if name == "storm_certified" and not pk.launches_by_shape.get(
                ("grid_launches", 8192, 4)):
            raise AssertionError(f"[bench] storm_certified's 8192-row "
                                 f"panel left the grid kernel: {_by_rung()}")
    _others_beside("bench")


def phase_bench_full(results, sections):
    """``sections`` through the port's bench module at the reference's
    depths (bench.DEPTHS["cuda"]), one after another in this process, each
    in a window of its own; the same gates as the bench phase's (b)."""
    from sqlp_tpu_torch import bench as pb

    instances = {}
    for name in sections:
        _bench_section(results, name, pb.DEPTHS["cuda"], instances,
                       "bench_full")


# the CLI phases start their subprocesses when they are reached and are
# waited for together, before the next phase that uses the card in this
# process (or at the end): the lands runs are host-bound and overlap
CLI_PHASES = {"cli": lambda results: start_cli(),
              "cli_cert": lambda results: start_cli_cert(),
              "cli_gap": start_cli_gap,
              "cli_run": start_cli_run}


def run_phase(ph, args, results, memo):
    """One phase that uses the card in this process; ``memo`` carries the
    main path's seeded bounds to ``main2``."""
    tp = time.perf_counter()
    if ph == "device":
        phase_device()
    elif ph in _PDHG_PHASES:
        phase_pdhg(results, ph)
    elif ph == "b3":
        phase_b3(results)
    elif ph == "sweep":
        phase_sweep(args.sweep_instances.split(","))
    elif ph == "digests":
        phase_digests()
    elif ph == "profile":
        phase_profile("main", 100)
        phase_profile("replicated", 20)
    elif ph == "main":
        memo["main"] = phase_main(results, args.iters, gate=True)
    elif ph == "main2":
        # the same seeded run again: the bounds must repeat bitwise
        again = phase_main(results, args.iters, path="main2")
        first = memo.get("main")
        log(f"[main2] lb_est, mc_ub equal to the first run: "
            f"{again == first}")
        if again != first:
            raise AssertionError(f"seeded main path not deterministic: "
                                 f"{first} then {again}")
    elif ph == "replicated":
        phase_replicated(results, args.rep_iters)
    elif ph == "small":
        phase_small(results)
    elif ph == "surface":
        phase_surface(results)
    elif ph == "bench":
        phase_bench(results)
    elif ph == "bench_full":
        phase_bench_full(results, args.bench_sections.split(","))
    elif ph == "storm":
        phase_storm(results, args.storm_iters)
    elif ph == "mesh":
        phase_mesh(results)
    elif ph == "mesh_nccl":
        phase_mesh_nccl()
    elif ph == "certify":
        memo["certify"] = phase_certify(results, args.cert_iters,
                                        args.cert_eval_samples)
    elif ph == "cert_polish":
        phase_cert_polish(results, memo)
    elif ph == "polish_witness":
        phase_polish_witness(memo)
    elif ph == "profile_ef":
        phase_profile_ef()
    else:
        raise ValueError(f"unknown phase {ph}")
    log(f"[{ph}] phase done in {time.perf_counter() - tp:.1f}s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200,
                    help="SD iterations of the ssn main path")
    ap.add_argument("--rep-iters", type=int, default=60,
                    help="SD iterations of the replicated path (its f32 "
                    "gate failed at 40: 7.63 %% more rounds)")
    ap.add_argument("--cert-iters", type=int, default=30,
                    help="SD iterations of the certified path (100 until "
                    "the script outgrew its 1200 s, then 50; the EF route "
                    "does not read them)")
    ap.add_argument("--cert-eval-samples", type=int, default=4096,
                    help="samples of the certified path's MC panels (16384 "
                    "until the storm phase needed the script's time, then "
                    "8192)")
    ap.add_argument("--storm-iters", type=int, default=200,
                    help="SD iterations of the storm path's f32 leg (the "
                    "reference bench runs 1500)")
    ap.add_argument("--phases",
                    default="device,b1,b2,b3,main,main2,replicated,small,"
                    "storm,certify,cert_polish,mesh,surface,bench,cli,"
                    "cli_cert,cli_gap,cli_run")
    ap.add_argument("--sweep-instances",
                    default="ssn,storm,lands,transship,baa99-20",
                    help="sweep: comma list of the instances whose shapes "
                    "it times (ssn and storm also time B3)")
    ap.add_argument("--bench-sections", default="throughput",
                    help="bench_full: comma list of the sections of "
                    "sqlp_tpu_torch/bench.py to run at the reference's "
                    "depths (throughput, ssn_time_to_gap, "
                    "storm_time_to_gap, storm_certified, ssn_certified, "
                    "lands_target_gap)")
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
    halpern = "sqlp_tpu/ops/pallas/pdhg_kernel.py:236"
    average = "sqlp_tpu/ops/pallas/pdhg_kernel.py:297"
    results = {name: {"name": name, "route": "cuda",
                      "source": src + name + ".cu", "replaces": site}
               for name, site in (
                   ("pdhg_halpern_round", halpern),
                   ("pdhg_halpern_cluster", halpern),
                   ("pdhg_halpern_tile", halpern),
                   ("pdhg_halpern_stream", halpern),
                   ("pdhg_halpern_grid", halpern),
                   ("pdhg_halpern_small", halpern),
                   ("pdhg_average_round", average),
                   ("pdhg_average_cluster", average),
                   ("pdhg_average_tile", average),
                   ("pdhg_average_stream", average),
                   ("pdhg_average_grid", average),
                   ("pdhg_average_small", average),
                   ("admm_round", "sqlp_tpu/ops/pallas/admm_kernel.py:95"))}
    t0 = time.perf_counter()
    pending = []
    memo = {}

    def join():
        for ph, tp, finish in pending:
            finish()
            log(f"[{ph}] phase done in {time.perf_counter() - tp:.1f}s "
                f"(beside the other CLI phases)")
        pending.clear()

    try:
        for ph in phases:
            if ph in CLI_PHASES:
                pending.append((ph, time.perf_counter(),
                                CLI_PHASES[ph](results)))
            else:
                join()
                run_phase(ph, args, results, memo)
        join()
    finally:
        for proc in _STARTED:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"[total] {time.perf_counter() - t0:.1f}s")
    for entry in results.values():
        entry.setdefault("library_ms", None)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
