"""Batched first-order LP solver (restarted PDHG, PDLP-style) on tensors.

Port of record: ``sqlp_tpu/ops/pdhg.py`` (``PreparedLP`` :56-86,
``prepare_lp`` :124-144, ``_kkt_residuals`` :152-194, ``solve_batch``
:197-521). A panel of recourse LPs

    min q @ y   s.t.  W y {>=,<=,==} h_b,   lb <= y <= ub        (b = 1..B)

shares W and differs in h_b (and, on random-cost instances, in q). The
solver keeps the reference's per-element restarts, primal-weight (omega)
adaptation, best-iterate latch, stall detection, warm starts, per-element
Q, the batch compaction ladder and the stats dict. The ``while_loop``
becomes a Python loop with one host read per restart round; the inner
round of ``restart_every`` steps is a CUDA kernel on the card and its
plain version on the CPU (ops/cuda/pdhg_kernel.py): ``pdhg_halpern_round``
under the default Halpern scheme, ``pdhg_average_round`` under
``scheme="average"``.

Duals come back in the JuMP d(obj)/d(rhs) sign convention ('>=' rows
>= 0, '<=' rows <= 0) that the cut math is written against.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from sqlp_tpu_torch.config import PDHGConfig
from sqlp_tpu_torch.models.stage import SENSE_E, SENSE_L
from sqlp_tpu_torch.ops.cuda.pdhg_kernel import (pdhg_average_round,
                                                 pdhg_halpern_round)
from sqlp_tpu_torch.utils.profiling import span
from sqlp_tpu_torch.utils.torchsetup import resolve_device

_BIG = 1e30  # stand-in for +inf inside clips (keeps NaNs away)

PREPARED_FIELDS = ("K", "q", "lb", "ub", "is_eq", "flip", "row_scale",
                   "col_scale", "step")


@dataclasses.dataclass(frozen=True)
class PreparedLP:
    """A stage LP preprocessed for batched PDHG.

    Scaled variables yt = y / col_scale, rows flipped so every inequality
    reads '>=', K = diag(row_scale) (flip * W) diag(col_scale).
    """

    K: torch.Tensor           # [m, n]
    q: torch.Tensor           # [n]
    lb: torch.Tensor          # [n] (may be -inf)
    ub: torch.Tensor          # [n] (may be +inf)
    is_eq: torch.Tensor       # [m] bool
    flip: torch.Tensor        # [m] +-1
    row_scale: torch.Tensor   # [m]
    col_scale: torch.Tensor   # [n]
    step: torch.Tensor        # scalar: 0.9 / ||K||_2

    @property
    def m(self) -> int:
        return self.K.shape[0]

    @property
    def n(self) -> int:
        return self.K.shape[1]


def prepared_lp_from_numpy(fields, dtype: Optional[torch.dtype] = None,
                           device="cuda") -> PreparedLP:
    """PreparedLP from a mapping of field name -> array-like (for example
    the JAX package's PreparedLP read through ``np.asarray``)."""
    device = resolve_device(device)
    a = {k: np.array(fields[k]) for k in PREPARED_FIELDS}
    if dtype is None:
        dtype = getattr(torch, str(a["K"].dtype))
    return PreparedLP(**{
        k: torch.as_tensor(v, device=device) if k == "is_eq"
        else torch.as_tensor(v, dtype=dtype, device=device)
        for k, v in a.items()})


def _ruiz_equilibrate(K: torch.Tensor, iters: int):
    """Ruiz scaling: iteratively divide rows/cols by sqrt of their inf-norm."""
    m, n = K.shape
    dr = torch.ones(m, dtype=K.dtype, device=K.device)
    dc = torch.ones(n, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        r = torch.sqrt(torch.amax(torch.abs(K), dim=1))
        r = torch.where(r > 0, r, torch.ones_like(r))
        K = K / r[:, None]
        c = torch.sqrt(torch.amax(torch.abs(K), dim=0))
        c = torch.where(c > 0, c, torch.ones_like(c))
        K = K / c[None, :]
        dr, dc = dr / r, dc / c
    return K, dr, dc


def _power_iteration(K: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Estimate ||K||_2 by power iteration on K^T K (deterministic start)."""
    n = K.shape[1]
    v = torch.cos(torch.arange(n, dtype=K.dtype, device=K.device) * 0.7
                  + 0.3)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = K.T @ (K @ v)
        v = w / torch.clamp_min(torch.linalg.norm(w), 1e-30)
    return torch.sqrt(torch.clamp_min(torch.linalg.norm(K.T @ (K @ v)),
                                      1e-30))


def prepare_lp(W: torch.Tensor, senses: torch.Tensor, q: torch.Tensor,
               lb: torch.Tensor, ub: torch.Tensor,
               ruiz_iters: int = 10) -> PreparedLP:
    """Preprocess a stage LP for batched solving (once per instance)."""
    dtype = W.dtype
    flip = torch.where(senses == SENSE_L, -1.0, 1.0).to(dtype)
    is_eq = senses == SENSE_E
    K0 = flip[:, None] * W
    K, dr, dc = _ruiz_equilibrate(K0, ruiz_iters)
    norm = _power_iteration(K)
    return PreparedLP(K=K, q=q * dc, lb=lb / dc, ub=ub / dc, is_eq=is_eq,
                      flip=flip, row_scale=dr, col_scale=dc,
                      step=(0.9 / norm).to(dtype))


def _project_dual(lam: torch.Tensor, is_eq: torch.Tensor) -> torch.Tensor:
    """Duals of '>=' rows live in R+; '==' rows are free."""
    return torch.where(is_eq[None, :], lam, torch.clamp_min(lam, 0.0))


def _kkt_residuals(lp: PreparedLP, ht: torch.Tensor, Y: torch.Tensor,
                   L: torch.Tensor, Qs: Optional[torch.Tensor] = None):
    """Relative primal/dual/gap residuals of a batch of iterates.

    ht: [B, m] scaled rhs; Y: [B, n]; L: [B, m]; Qs: optional [B, n]
    per-element scaled objective. Returns (err, pobj), err the max of the
    three relative residuals per batch element.
    """
    qm = lp.q[None, :] if Qs is None else Qs
    KY = Y @ lp.K.T
    slack = ht - KY
    pviol = torch.where(lp.is_eq[None, :], torch.abs(slack),
                        torch.clamp_min(slack, 0.0))
    pres = torch.linalg.norm(pviol, dim=-1) / (
        1.0 + torch.linalg.norm(ht, dim=-1))

    g = qm - L @ lp.K
    lo_inf = ~torch.isfinite(lp.lb)
    hi_inf = ~torch.isfinite(lp.ub)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    dviol = (torch.where(hi_inf[None, :], torch.clamp_min(-g, 0.0), zero)
             + torch.where(lo_inf[None, :], torch.clamp_min(g, 0.0), zero))
    qn = torch.linalg.norm(lp.q) if Qs is None \
        else torch.linalg.norm(Qs, dim=-1)
    dres = torch.linalg.norm(dviol, dim=-1) / (1.0 + qn)

    pobj = Y @ lp.q if Qs is None else torch.sum(Y * Qs, dim=-1)
    gpos = torch.clamp_min(g, 0.0)
    gneg = torch.clamp_min(-g, 0.0)
    lb_term = torch.where(torch.isfinite(lp.lb), lp.lb, zero)
    ub_term = torch.where(torch.isfinite(lp.ub), lp.ub, zero)
    dobj = torch.sum(L * ht, dim=-1) + gpos @ lb_term - gneg @ ub_term
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))

    err = torch.maximum(torch.maximum(pres, dres), gap)
    return err, pobj


def solve_batch(lp: PreparedLP, H: torch.Tensor,
                config: PDHGConfig = PDHGConfig(),
                Y0: Optional[torch.Tensor] = None,
                L0: Optional[torch.Tensor] = None,
                Q: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict]:
    """Solve the LP for a panel of right-hand sides.

    H: [B, m] raw right-hand sides in the original row senses; Y0, L0:
    optional warm starts in original units; Q: optional [B, n] per-element
    objective in original units. Returns (obj [B], Y [B, n], Pi [B, m],
    stats); Pi in the JuMP d(obj)/d(rhs) convention, all unscaled.

    Spans (``utils/profiling.py``, under a profiler only): ``pdhg.solve``
    around the call (B, itemsize, rounds); ``pdhg.compact`` around each
    compaction's sort and gather and its scatter back (the rung's rows);
    ``pdhg.round`` for each restart round (the rung's rows), from the
    return of the host read that admitted it to the return of the next,
    so the rounds of a rung tile its loop, with the stamps ``launched``
    (the round's kernel enqueued) and ``enqueued`` (the whole round).
    """
    with span("pdhg.solve", B=H.shape[0],
              itemsize=lp.K.element_size()) as s:
        out = _solve_batch(lp, H, config, Y0, L0, Q)
        s.set(rounds=out[3]["pdhg_rounds"])
    return out


def _solve_batch(lp, H, config, Y0, L0, Q):
    B, m = H.shape
    n = lp.n
    dtype = lp.K.dtype
    dev = lp.K.device
    H = H.to(dtype)
    if Q is not None:
        Q = Q.to(dtype)

    ht = H * (lp.flip * lp.row_scale)[None, :]
    lb = torch.where(torch.isfinite(lp.lb), lp.lb,
                     torch.full_like(lp.lb, -_BIG)).contiguous()
    ub = torch.where(torch.isfinite(lp.ub), lp.ub,
                     torch.full_like(lp.ub, _BIG)).contiguous()
    K = lp.K.contiguous()
    is_eq = lp.is_eq.contiguous()
    eta = lp.step
    n_rounds = max(1, config.max_iters // config.restart_every)
    halpern = config.scheme == "halpern"
    if config.scheme not in ("halpern", "average"):
        raise ValueError(f"unknown PDHG scheme {config.scheme!r}")

    def round_step(el, rec):
        """One restart round on a dict of per-element state; ``rec`` is
        the round's span."""
        Qs = el.get("Q")
        tau = eta / el["omega"]
        sig = eta * el["omega"]
        if halpern:
            Ycarry, Lcarry, Yc, Lc = pdhg_halpern_round(
                K, lp.q if Qs is None else Qs, lb, ub, is_eq,
                el["ht"], tau, sig, el["Y"], el["L"], el["kh"],
                el["Yanc"], el["Lanc"], config.restart_every)
            cands = [(Yc, Lc)]
        else:
            Ycarry, Lcarry, Ya, La = pdhg_average_round(
                K, lp.q if Qs is None else Qs, lb, ub, is_eq, el["ht"], tau,
                sig, el["Y"], el["L"], config.restart_every)
            cands = [(Ycarry, Lcarry), (Ya, La)]
        rec.mark("launched")

        Yc, Lc = cands[0]
        err, _ = _kkt_residuals(lp, el["ht"], Yc, Lc, Qs)
        for Yo, Lo in cands[1:]:
            err_o, _ = _kkt_residuals(lp, el["ht"], Yo, Lo, Qs)
            use_o = err_o < err
            Yc = torch.where(use_o[:, None], Yo, Yc)
            Lc = torch.where(use_o[:, None], Lo, Lc)
            err = torch.minimum(err_o, err)

        better = err < el["err_best"]
        Yb = torch.where(better[:, None], Yc, el["Yb"])
        Lb = torch.where(better[:, None], Lc, el["Lb"])
        meaningful = err < el["err_best"] * 0.97
        stall = torch.where(meaningful, torch.zeros_like(el["stall"]),
                            el["stall"] + 1)
        err_best = torch.minimum(err, el["err_best"])
        done = (err_best <= config.tol) | (stall >= config.stall_rounds)

        restart = (err <= 0.2 * el["err_r"]) | (
            (err <= 0.8 * el["err_r"]) & (err > el["err_last"]))

        dY = torch.linalg.norm(Yc - el["Yr"], dim=-1)
        dL = torch.linalg.norm(Lc - el["Lr"], dim=-1)
        theta = config.omega_smoothing
        omega = el["omega"]
        omega_new = torch.where(
            (dY > 1e-12) & (dL > 1e-12),
            torch.exp(theta * torch.log(dL / torch.clamp_min(dY, 1e-30))
                      + (1.0 - theta) * torch.log(omega)),
            omega)
        omega_new = torch.clamp(omega_new, el["olo"], el["ohi"])

        r = restart[:, None]
        out = dict(
            el,
            Y=torch.where(r, Yc, Ycarry), L=torch.where(r, Lc, Lcarry),
            Yr=torch.where(r, Yc, el["Yr"]), Lr=torch.where(r, Lc, el["Lr"]),
            Yb=Yb, Lb=Lb,
            omega=torch.where(restart, omega_new, omega),
            err_r=torch.where(restart, err, el["err_r"]),
            err_last=err, err_best=err_best, done=done, stall=stall)
        if halpern:
            out["kh"] = torch.where(restart, torch.zeros_like(el["kh"]),
                                    el["kh"] + config.restart_every)
            out["Yanc"] = torch.where(r, Yc, el["Yanc"])
            out["Lanc"] = torch.where(r, Lc, el["Lanc"])
        return out

    if Y0 is None:
        Yi = torch.clamp(torch.zeros((B, n), dtype=dtype, device=dev),
                         lb, ub)
    else:
        Yi = torch.clamp(Y0.to(dtype) / lp.col_scale[None, :], lb, ub)
    if L0 is None:
        Li = torch.zeros((B, m), dtype=dtype, device=dev)
    else:
        Li = _project_dual(L0.to(dtype) / (lp.row_scale * lp.flip)[None, :],
                           lp.is_eq)
    # PDLP primal-weight initialization: omega ~ ||q|| / ||h||
    Qs = None if Q is None else (Q * lp.col_scale[None, :]).contiguous()
    qn = torch.linalg.norm(lp.q) if Qs is None \
        else torch.linalg.norm(Qs, dim=-1)
    hn = torch.linalg.norm(ht, dim=-1)
    omega_init = torch.where((qn > 1e-30) & (hn > 1e-30),
                             qn / torch.clamp_min(hn, 1e-30),
                             torch.ones(B, dtype=dtype, device=dev))
    err0 = torch.full((B,), float("inf"), dtype=dtype, device=dev)

    el = dict(
        ht=ht.contiguous(), Y=Yi, L=Li, Yr=Yi, Lr=Li, Yb=Yi, Lb=Li,
        omega=omega_init, olo=omega_init * 1e-4, ohi=omega_init * 1e4,
        err_r=err0, err_last=err0, err_best=err0,
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        stall=torch.zeros(B, dtype=torch.int32, device=dev),
        orig=torch.arange(B, dtype=torch.int64, device=dev))
    if Qs is not None:
        el["Q"] = Qs
    if halpern:
        el.update(kh=torch.zeros(B, dtype=dtype, device=dev), Yanc=Yi,
                  Lanc=Li)

    # Batch compaction ladder (sqlp_tpu/ops/pdhg.py:443-489): once the
    # active count fits the next rung, sort converged elements out and run
    # the tail on the prefix; finished elements scatter back via `orig`.
    sizes = [B]
    if config.compaction and B >= config.compact_min_batch:
        floor = 256
        while len(sizes) < 4:
            nxt = -(-max(floor, sizes[-1] // 4) // floor) * floor
            if nxt >= sizes[-1]:
                break
            sizes.append(nxt)

    it = 0
    phase_rounds = []
    for phase_i, size in enumerate(sizes):
        stop = sizes[phase_i + 1] if phase_i + 1 < len(sizes) else 0
        compact = size < el["done"].shape[0]
        if compact:
            with span("pdhg.compact", rows=size):
                order = torch.argsort(el["done"].to(torch.int32),
                                      stable=True)[:size]
                sub = {k: v[order].contiguous() for k, v in el.items()}
        else:
            sub = el
        # one host read per restart round: the loop condition
        go = it < n_rounds and int((~sub["done"]).sum()) > stop
        while go:
            with span("pdhg.round", rows=size) as rec:
                sub = round_step(sub, rec)
                rec.mark("enqueued")
                it += 1
                go = it < n_rounds and int((~sub["done"]).sum()) > stop
        phase_rounds.append(it)
        if compact:
            with span("pdhg.compact", rows=size):
                el = {k: el[k].index_copy(0, sub["orig"], sub[k])
                      for k in el}
        else:
            el = sub
    rounds = it

    Yb, Lb = el["Yb"], el["Lb"]
    err, done = el["err_best"], el["done"]
    Y_out = Yb * lp.col_scale[None, :]
    Pi_out = Lb * (lp.row_scale * lp.flip)[None, :]
    obj = Y_out @ (lp.q / lp.col_scale) if Q is None \
        else torch.sum(Y_out * Q, dim=-1)

    stats = {
        "pdhg_rounds": rounds,
        "pdhg_phase_rounds": phase_rounds,
        "pdhg_iters": rounds * config.restart_every,
        "pdhg_err_max": torch.amax(err),
        "pdhg_converged": torch.all(err <= config.tol),
        "pdhg_omega": torch.mean(el["omega"]),
        "pdhg_done": done,
        "pdhg_valid": err <= config.valid_tol,
        "pdhg_err": err,
    }
    return obj, Y_out, Pi_out, stats
