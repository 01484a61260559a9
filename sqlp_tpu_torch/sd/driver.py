"""Host-side SD driver: init, iterate, evaluate.

Port of record: ``sqlp_tpu/sd/driver.py:SDSolver`` (``__init__`` :45-187,
``step`` :198, ``step_scenarios`` :206-234, ``run`` :250-304,
``_warmstart_pool`` :483, ``_prep_sub64`` :493-508, ``_recourse_objs``
:510-678, ``evaluate`` :689-715, ``evaluate_ci`` :717-819).

Every tensor lives on the instance's device; the solver owns an explicit
``torch.Generator`` on that device, seeded from ``seed``, for the scenario
stream and the reservoir. The MC evaluators seed their own generators.
Not ported (refused by the CLI, absent here): meshes, replications,
importance-sampling proposals, checkpoint I/O, certified bounds.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import Instance
from sqlp_tpu_torch.models.routines import (project_first_stage,
                                            recourse_lower_bound,
                                            solve_lp_host)
from sqlp_tpu_torch.models.scenario import (cost_panel, sample_deltas,
                                            values_to_deltas)
from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs, sd_run, sd_step
from sqlp_tpu_torch.sd.state import (EpigraphSpec, SDState,
                                     default_epigraph_spec, init_state,
                                     state_to_numpy)
from sqlp_tpu_torch.utils.torchsetup import configure_torch


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class SDSolver:
    """Two-stage regularized SD solver on a compiled instance."""

    # stats keys expressed in (scaled) objective units — unscaled on read
    _OBJ_KEYS = ("cand_est", "inc_est", "req_improvement", "sub_obj_mean",
                 "rho")

    def __init__(self, inst: Instance, config: SDConfig = SDConfig(),
                 espec: Optional[EpigraphSpec] = None, x0=None,
                 seed: int = 0, n_epi: int = 1):
        configure_torch()
        if config.cut_refresh_every > 0:
            raise NotImplementedError(
                "cut_refresh_every > 0 is not ported yet (ROADMAP: cut "
                "refresh)")
        self.inst = inst
        self.device = inst.device
        if inst.scenario_model.has_cost:
            if not inst.scenario_model.seed_valid:
                raise ValueError(
                    f"instance {inst.name} has random cost coefficients "
                    f"with no universally feasible dual; SD cut "
                    f"generation cannot be certified")
            if config.dual_crossover:
                config = config.replace(dual_crossover=False)
            if config.normalize_objective:
                config = config.replace(normalize_objective=False)
        # valid per-scenario recourse lower bound (one host LP)
        self.recourse_lb = recourse_lower_bound(inst.arrays,
                                                inst.scenario_model)
        dt = config.jdtype
        if espec is None:
            lb_auto = self.recourse_lb if np.isfinite(self.recourse_lb) \
                else 0.0
            espec = default_epigraph_spec(n_epi, 1.0 / n_epi, lb_auto,
                                          dtype=dt, device=self.device)
        elif np.isfinite(self.recourse_lb):
            bad = _host(espec.lower_bound) > self.recourse_lb + 1e-9 * (
                1.0 + abs(self.recourse_lb))
            if bad.any():
                warnings.warn(
                    f"epigraph lower bound {_host(espec.lower_bound)} "
                    f"exceeds the valid recourse bound "
                    f"{self.recourse_lb:.6g}; cuts blended with it are "
                    f"invalid and SD may converge to the wrong point")
        self.espec = espec

        # objective normalization: run in units of cost / s
        s = 1.0
        if config.normalize_objective:
            s = float(max(1.0,
                          np.abs(_host(inst.arrays.c)).max(initial=0.0),
                          np.abs(_host(inst.arrays.q)).max(initial=0.0)))
        self.obj_scale = s
        arrays = inst.arrays
        if s != 1.0:
            arrays = dataclasses.replace(arrays, c=arrays.c / s,
                                         q=arrays.q / s)
            self.espec = dataclasses.replace(
                self.espec, lower_bound=self.espec.lower_bound / s)
            config = config.replace(
                quad_scalar_init=config.quad_scalar_init / s,
                quad_min=config.quad_min / s,
                quad_max=config.quad_max / s,
                cut_remove_tolerance=config.cut_remove_tolerance / s)
        self.arrays = arrays
        self.config = config

        self.prep_sub = prepare_lp(
            arrays.W, arrays.senses2, arrays.q, arrays.lb2, arrays.ub2,
            ruiz_iters=config.pdhg.ruiz_iters)
        if x0 is None:
            x0 = np.zeros(inst.n1)
        x0, moved = project_first_stage(inst.arrays, np.asarray(x0))
        if moved > 0.0:
            warnings.warn(
                f"x0 violated the first-stage constraints; projected onto "
                f"the feasible set (1-norm distance {moved:.6g})")
        self.state: SDState = init_state(inst, self.espec, config, x0)
        self.scenario_model = inst.scenario_model
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.host_fallback_count = 0
        self.history: List[Dict] = []

    def _unscale(self, stats: Dict) -> Dict:
        if self.obj_scale == 1.0:
            return stats
        out = dict(stats)
        for k in self._OBJ_KEYS:
            if k in out:
                out[k] = out[k] * self.obj_scale
        return out

    def step(self) -> Dict:
        """One SD iteration on sampled scenarios; objective-unit stats are
        unscaled."""
        self.state, stats = sd_step(
            self.arrays, self.scenario_model, self.espec, self.prep_sub,
            self.state, self.config, self.generator)
        return self._unscale(stats)

    def step_scenarios(self, values=None, deltas=None, weights=None) -> Dict:
        """One SD iteration on user-supplied scenarios: ``values`` [n_epi,
        B, R] raw sto-position values or ``deltas`` (value - template);
        ``weights`` [n_epi, B] optional."""
        if (values is None) == (deltas is None):
            raise ValueError("pass exactly one of values= or deltas=")
        dt = self.config.jdtype
        if deltas is None:
            deltas = values_to_deltas(self.inst.scenario_model, values)
        deltas = torch.as_tensor(deltas, dtype=dt, device=self.device)
        if weights is not None:
            weights = torch.as_tensor(weights, dtype=dt, device=self.device)
        self.state, stats = sd_step(
            self.arrays, self.scenario_model, self.espec, self.prep_sub,
            self.state, self.config, self.generator, deltas=deltas,
            weights=weights)
        return self._unscale(stats)

    def run(self, n_iters: int, log_every: int = 0,
            callback: Optional[Callable[[int, Dict], None]] = None,
            chunk: int = 256) -> Dict:
        """Run n_iters iterations in chunks with one stats readback per
        chunk; returns the last iteration's scalar stats."""
        last: Dict = {}
        done = 0
        while done < n_iters:
            n = min(chunk, n_iters - done)
            self.state, packed, keys = sd_run(
                self.arrays, self.scenario_model, self.espec, self.prep_sub,
                self.state, self.config, n, self.generator)
            acc = self._unscale({k: packed[:, j] for j, k in
                                 enumerate(keys)})
            done += n
            if not np.all(np.isfinite(acc["cand_est"])):
                dump = os.path.abspath("error_state.npz")
                np.savez(dump, **state_to_numpy(self.state))
                bad = int(acc["it"][np.argmax(~np.isfinite(acc["cand_est"]))])
                raise FloatingPointError(
                    f"non-finite candidate estimate at iteration {bad}; "
                    f"state dumped to {dump}")
            if log_every:
                for j in range(n):
                    if int(acc["it"][j]) % log_every == 0:
                        self.history.append(
                            {k: acc[k][j].item() for k in acc})
            last = {k: acc[k][-1] for k in acc}
            if callback:
                callback(done, last)
        return last

    @property
    def x_incumbent(self) -> np.ndarray:
        return _host(self.state.x_incumbent)

    @property
    def x_candidate(self) -> np.ndarray:
        return _host(self.state.x_candidate)

    @property
    def lower_estimate(self) -> float:
        """Candidate objective estimate under the current cuts (the lb
        proxy the reference drivers print; not a valid bound)."""
        return float(self.state.cand_est) * self.obj_scale

    def _warmstart_pool(self) -> Optional[np.ndarray]:
        """Live dual-vertex pool [n_duals, m2] (f64, host) or None."""
        n_duals = int(self.state.n_duals)
        if n_duals <= 0:
            return None
        return np.asarray(_host(self.state.duals[:n_duals]), np.float64)

    @property
    def _prep_sub64(self):
        """f64 PreparedLP for the MC evaluator's escalation re-solve,
        built lazily on the solver's device."""
        cached = getattr(self, "_prep_sub64_cache", None)
        if cached is None:
            a = self.arrays
            f8 = torch.float64
            cached = prepare_lp(a.W.to(f8), a.senses2, a.q.to(f8),
                                a.lb2.to(f8), a.ub2.to(f8),
                                ruiz_iters=self.config.pdhg.ruiz_iters)
            self._prep_sub64_cache = cached
        return cached

    def _recourse_objs(self, H: torch.Tensor, Q=None) -> np.ndarray:
        """Recourse objectives for an RHS panel, certified per element:
        elements the first solve could not certify to ``valid_tol`` walk
        the escalation ladder — a pool-warm-started re-solve, then an f64
        re-solve (the f64 instance of the same kernel on the card), then
        the exact host solver."""
        dev = self.device
        dt = self.config.jdtype
        pdhg = self.config.pdhg
        Qn = None if Q is None else np.asarray(_host(Q), np.float64)
        L0 = None
        pool = self._warmstart_pool()
        if pool is not None and not self.inst.scenario_model.has_cost:
            pool_t = torch.as_tensor(pool, dtype=dt, device=dev)
            L0 = pool_t[torch.argmax(pool_t @ H.to(dt).T, dim=0)]
        obj, _, _, stats = solve_batch(self.prep_sub, H, pdhg, L0=L0, Q=Q)
        vals = np.array(_host(obj), np.float64)
        valid = _host(stats["pdhg_valid"])
        bad = np.flatnonzero(~valid)
        Hn = np.asarray(_host(H), np.float64)
        if bad.size:
            bucket = max(256, 1 << (int(bad.size) - 1).bit_length())
            idx = np.pad(bad, (0, bucket - bad.size), mode="edge")
            Hb = torch.as_tensor(Hn[idx], dtype=dt, device=dev)
            Qb = None if Qn is None else torch.as_tensor(
                Qn[idx], dtype=dt, device=dev)
            L0 = None
            if pool is not None:
                L0 = torch.as_tensor(pool[np.argmax(pool @ Hn[idx].T,
                                                    axis=0)],
                                     dtype=dt, device=dev)
            obj_r, Y_r, Pi_r, st_r = solve_batch(self.prep_sub, Hb, pdhg,
                                                 L0=L0, Q=Qb)
            fixed = _host(st_r["pdhg_valid"])[:bad.size]
            vals[bad[fixed]] = np.asarray(_host(obj_r),
                                          np.float64)[:bad.size][fixed]
            rem_pos = np.flatnonzero(~fixed)
            bad = bad[~fixed]
            if bad.size:
                # f64 escalation, warm-started from the f32 iterate
                bucket2 = max(256, 1 << (int(bad.size) - 1).bit_length())
                idx2 = np.pad(bad, (0, bucket2 - bad.size), mode="edge")
                pos2 = np.pad(rem_pos, (0, bucket2 - rem_pos.size),
                              mode="edge")
                f8 = torch.float64
                Y64 = Y_r.to(f8)[torch.as_tensor(pos2, device=dev)]
                P64 = Pi_r.to(f8)[torch.as_tensor(pos2, device=dev)]
                cfg64 = dataclasses.replace(
                    pdhg, max_iters=min(pdhg.max_iters, 20_000))
                obj2, _, _, st2 = solve_batch(
                    self._prep_sub64,
                    torch.as_tensor(Hn[idx2], dtype=f8, device=dev), cfg64,
                    Y0=Y64, L0=P64,
                    Q=None if Qn is None else torch.as_tensor(
                        Qn[idx2], dtype=f8, device=dev))
                fixed2 = _host(st2["pdhg_valid"])[:bad.size]
                vals[bad[fixed2]] = np.asarray(
                    _host(obj2), np.float64)[:bad.size][fixed2]
                bad = bad[~fixed2]
        if bad.size:
            a = self.arrays
            q = np.asarray(_host(a.q), np.float64)
            W = np.asarray(_host(a.W), np.float64)
            s2 = _host(a.senses2)
            lb = np.asarray(_host(a.lb2), np.float64)
            ub = np.asarray(_host(a.ub2), np.float64)
            for b in bad:
                try:
                    vals[b], _, _ = solve_lp_host(
                        q if Qn is None else Qn[b], W, Hn[b], s2, lb, ub)
                except RuntimeError as e:
                    raise RuntimeError(
                        f"recourse LP infeasible/unsolvable at the "
                        f"evaluated x for scenario row {b} (is x "
                        f"first-stage feasible?): {e}") from e
            self.host_fallback_count += int(bad.size)
            if bad.size > 0.01 * len(vals):
                warnings.warn(
                    f"{bad.size}/{len(vals)} recourse LPs missed "
                    f"valid_tol={pdhg.valid_tol:g} after the device "
                    f"escalation ladder; re-solved exactly on the host")
        return vals

    def _cost_panel(self, deltas):
        if not self.inst.scenario_model.has_cost:
            return None
        return cost_panel(self.inst.scenario_model, deltas, self.arrays.q)

    def _eval_point(self, x):
        return torch.as_tensor(np.asarray(
            self.x_incumbent if x is None else x), dtype=self.config.jdtype,
            device=self.device)

    def evaluate(self, x=None, n_samples: int = 10_000, seed: int = 123,
                 batch: int = 4096) -> float:
        """Monte-Carlo upper-bound estimate at x (iid draws)."""
        x = self._eval_point(x)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        total = 0.0
        done = 0
        while done < n_samples:
            b = min(batch, n_samples - done)
            deltas = sample_deltas(gen, self.inst.scenario_model, b)
            H = _scenario_rhs(self.arrays, self.inst.scenario_model,
                              deltas, x)
            total += float(self._recourse_objs(
                H, Q=self._cost_panel(deltas)).sum())
            done += b
        first = float(self.arrays.c @ x)
        return (first + total / n_samples) * self.obj_scale

    def evaluate_ci(self, x=None, confidence: float = 0.95,
                    target_half_width: float = 0.0,
                    min_samples: int = 2048, max_samples: int = 262_144,
                    seed: int = 123, batch: int = 4096):
        """Monte-Carlo estimate with a confidence interval over iid draws
        (the per-element estimator of the port of record). With
        ``target_half_width > 0`` sampling continues in batches until the
        half-width falls below it or ``max_samples`` is reached. The width
        is floored at ``valid_tol`` relative, the per-element solver
        accuracy. Returns (mean, half_width, n_samples)."""
        from scipy.special import erfinv

        x = self._eval_point(x)
        z = math.sqrt(2.0) * float(erfinv(confidence))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n = 0
        mean = 0.0
        m2 = 0.0

        def half_width() -> float:
            hw = z * math.sqrt(m2 / max(n - 1, 1) / max(n, 1))
            return max(hw, self.config.pdhg.valid_tol * (1.0 + abs(mean)))

        while True:
            stop_at = min_samples if not target_half_width else max_samples
            b = min(batch, stop_at - n)
            if b <= 0:
                break
            deltas = sample_deltas(gen, self.inst.scenario_model, b)
            H = _scenario_rhs(self.arrays, self.inst.scenario_model,
                              deltas, x)
            vals = self._recourse_objs(H, Q=self._cost_panel(deltas))
            # Chan et al. parallel-variance merge of the batch's moments
            bn = len(vals)
            bm = float(vals.mean())
            bm2 = float(((vals - bm) ** 2).sum())
            delta = bm - mean
            tot = n + bn
            mean += delta * bn / tot
            m2 += bm2 + delta * delta * n * bn / tot
            n = tot
            if target_half_width and n >= min_samples \
                    and half_width() <= target_half_width:
                break
        hw = half_width()
        first = float(self.arrays.c @ x)
        s_ = self.obj_scale
        return (first + mean) * s_, hw * s_, n
