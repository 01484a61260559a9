"""Host-side SD driver: init, iterate, evaluate.

Port of record: ``sqlp_tpu/sd/driver.py:SDSolver`` (``__init__`` :45-187,
``step`` :198, ``step_scenarios`` :206-234, ``run`` :250-304,
``cut_model_lower_bound`` :322-329, ``polish_decision`` :331-347,
``saa_lower_bound`` :349-362, ``select_decision`` :364-396,
``sharpen_duals_host`` :398-481, ``_warmstart_pool`` :483, ``_prep_sub64``
:493-508, ``_recourse_objs`` :510-678, ``evaluate`` :689-715,
``evaluate_ci`` :717-819), ``solve_instance`` (:822-840) and
``SDReplications`` (:843-940, ``certified_lower_bound`` :941-1032,
``solve_to_certified_gap`` :1034-1164, 1165-1186).

Every tensor lives on the instance's device; the solver owns an explicit
``torch.Generator`` on that device, seeded from ``seed``, for the scenario
stream and the reservoir (``SDReplications``: one per replication, seeded
``seed + r``). The MC evaluators seed their own generators. Where the
reference asserts a precondition a caller can reach, the port raises
ValueError. Beyond the reference: with ``antithetic_reps`` every
per-replication array, ``lb_per_rep`` included, keeps length R, and
``solve_to_certified_gap`` splits its confidence over its planned looks.
``SDSolver(proposal=...)`` draws the scenario stream from an
importance-sampling proposal (``models/instance.py:load_proposal``).
``SDSolver(mesh_devices=N | mesh_shape=(nd, ns), shard_duals=...)``
shards the scenario stores and the dual pool over the ranks of an
initialized ``torch.distributed`` group (``parallel/mesh.py``, reference
:163-186); every rank constructs the solver and calls every method, and
the Monte-Carlo panels shard their rows over all ranks. Host dual
sharpening and the decision polish (which reuses its own solves) stay
single-device paths (ValueError with a mesh), as do the replications,
which take no mesh.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import Instance, load_instance
from sqlp_tpu_torch.models.routines import (project_first_stage,
                                            recourse_lower_bound,
                                            solve_lp_host)
from sqlp_tpu_torch.models.scenario import (cost_panel, sample_deltas,
                                            values_to_deltas)
from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch
from sqlp_tpu_torch.parallel.mesh import (gather_state, make_mesh,
                                          make_mesh_2d, place_batch,
                                          shard_state, to_host)
from sqlp_tpu_torch.sd.algorithm import (_scenario_rhs, sd_run,
                                         sd_run_replicated, sd_step)
from sqlp_tpu_torch.sd.compromise import (compromise_decision,
                                          polish_decision)
from sqlp_tpu_torch.sd.dual_pool import push_duals
from sqlp_tpu_torch.sd.lower_bound import (certified_lower_bound,
                                           cut_model_min, saa_ef_bound,
                                           saa_polish, t_lower_bound)
from sqlp_tpu_torch.sd.state import (EpigraphSpec, SDState,
                                     default_epigraph_spec, init_state,
                                     stack_states, state_at, state_to_numpy)
from sqlp_tpu_torch.utils.profiling import span
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
                 seed: int = 0, n_epi: int = 1, proposal=None,
                 mesh_devices: int = 0, shard_duals: bool = False,
                 mesh_shape: Optional[tuple] = None):
        """``proposal`` (a ScenarioModel over the same positions, see
        ``models.instance.load_proposal``) switches the scenario stream
        to importance sampling on the device: draws come from the
        proposal, weights are the exact density ratios.

        ``mesh_devices`` > 1 lays a 1-D mesh over that many ranks (the
        world of the initialized ``torch.distributed`` group, one rank
        per process) and shards the scenario stores over it, the dual
        pool too with ``shard_duals``; ``mesh_shape=(nd, ns)`` lays a 2-D
        (duals x scenarios) mesh instead, the pool over nd ranks and the
        stores over ns. ValueError when the capacities do not divide over
        their axes, or for ``shard_duals`` without a mesh."""
        configure_torch()
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
        self.proposal = proposal
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.host_fallback_count = 0
        self.history: List[Dict] = []
        self.mesh = None
        if mesh_shape is not None or mesh_devices > 1:
            if mesh_shape is not None:
                nd, ns = mesh_shape
            else:
                nd, ns = (mesh_devices if shard_duals else 1), mesh_devices
            if config.max_scenarios % ns:
                raise ValueError(f"max_scenarios {config.max_scenarios} "
                                 f"must divide over the {ns} ranks of the "
                                 f"scenario axis")
            if config.max_dual_vertices % nd:
                raise ValueError(f"max_dual_vertices "
                                 f"{config.max_dual_vertices} must divide "
                                 f"over the {nd} ranks of the dual axis")
            self.mesh = make_mesh_2d(nd, ns) if mesh_shape is not None \
                else make_mesh(mesh_devices, shard_duals=shard_duals)
            self.state = shard_state(self.state, self.mesh)
        elif shard_duals:
            raise ValueError("shard_duals needs a mesh (mesh_devices > 1 "
                             "or mesh_shape)")

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
            self.state, self.config, self.generator, proposal=self.proposal,
            mesh=self.mesh)
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
            weights=weights, mesh=self.mesh)
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
                self.state, self.config, n, self.generator,
                proposal=self.proposal, mesh=self.mesh)
            acc = self._unscale({k: packed[:, j] for j, k in
                                 enumerate(keys)})
            done += n
            if not np.all(np.isfinite(acc["cand_est"])):
                from sqlp_tpu_torch.utils.checkpoint import save_state
                dump = os.path.abspath("error_state.npz")
                save_state(dump, self.state, self.generator, mesh=self.mesh,
                           instance=self.inst.name)
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

    def cut_model_lower_bound(self) -> float:
        """Exact minimum of the current cut model over the first-stage
        polytope (host HiGHS, f64): a deterministic lower bound on this
        run's sample-average optimum, unlike :attr:`lower_estimate`."""
        return cut_model_min(self.arrays, self.espec, self.state,
                             obj_scale=self.obj_scale)

    def polish_decision(self, x0, n_scenarios: int = 8192,
                        rounds: int = 12, rho: float = 20.0,
                        seed: int = 4242, **kw):
        """Proximal-bundle polish of a first-stage decision on one fresh
        stratified panel (``sd/compromise.py:polish_decision``), each
        round's values certified by the evaluator's escalation ladder.
        ``rho`` is in user objective units. Evaluate the returned x on an
        independent sample for an unbiased cost estimate. A single-device
        path: ValueError on a mesh (each round reuses its own solve)."""
        if self.mesh is not None:
            raise ValueError("the decision polish is a single-device path: "
                             "it does not run on a mesh")
        return polish_decision(self.arrays, self.scenario_model,
                               self.prep_sub, self.config, x0,
                               obj_scale=self.obj_scale,
                               n_scenarios=n_scenarios, rounds=rounds,
                               rho=rho / self.obj_scale, seed=seed,
                               values_fn=self._recourse_objs, **kw)

    def saa_lower_bound(self, max_rounds: int = 24, gap_tol: float = 1e-4,
                        extra_scenarios: int = 0, seed: int = 9000) -> Dict:
        """The level-bundle-polished deterministic bound on this run's SAA
        optimum (``sd/lower_bound.py:saa_polish``); ``lb_per_rep[0]`` is
        the bound. On a mesh every rank polishes the gathered state."""
        state = self.state if self.mesh is None \
            else gather_state(self.state, self.mesh)
        return saa_polish(self.arrays, self.scenario_model, self.espec,
                          self.prep_sub, [state], self.config,
                          obj_scale=self.obj_scale, max_rounds=max_rounds,
                          gap_tol=gap_tol, extra_scenarios=extra_scenarios,
                          seed=seed)

    def sharpen_duals_host(self, k: int = 32, x=None) -> Dict:
        """Host-exact dual sharpening: re-solve with HiGHS the home
        scenarios of the pool's top-``k`` vertices by usage score (each
        one's home: the stored scenario where it scores highest, at x,
        default the incumbent) and push the exact basic duals into the
        pool. Any dual-feasible vector is a valid pool entry, so cut
        validity is untouched.

        Returns ``n_solved``, ``n_new`` (entries the dedup accepted) and
        ``mean_slack`` / ``max_slack``: the exact optimum less the pool's
        argmax value on the re-solved scenarios (scaled objective units).
        Raises ValueError on random-cost instances, whose pools carry
        per-scenario admissibility, and on a mesh (a single-device
        path, as in the reference)."""
        if self.mesh is not None:
            raise ValueError("host dual sharpening is a single-device path: "
                             "it does not run on a mesh")
        if self.inst.scenario_model.has_cost:
            raise ValueError("host dual sharpening is not defined on "
                             "random-cost instances: their pools carry "
                             "per-scenario admissibility")
        none = {"n_solved": 0, "n_new": 0, "mean_slack": 0.0,
                "max_slack": 0.0}
        state = self.state
        nd = int(state.n_duals)
        if nd == 0:
            return none
        duals = np.asarray(_host(state.duals), np.float64)[:nd]
        score = np.asarray(_host(state.duals_score), np.float64)[:nd]
        x = np.asarray(self.x_incumbent if x is None else x, np.float64)
        dt = self.config.jdtype
        n_scen = _host(state.n_scen)
        x_t = torch.as_tensor(x, dtype=dt, device=self.device)
        H = [np.asarray(_host(_scenario_rhs(
            self.arrays, self.scenario_model,
            state.scen_deltas[e, :int(n_scen[e])], x_t)), np.float64)
            for e in range(n_scen.shape[0]) if int(n_scen[e]) > 0]
        if not H:
            return none
        H = np.concatenate(H)
        winners = np.argsort(score)[::-1][:min(k, nd)]
        home = np.unique(np.argmax(duals[winners] @ H.T, axis=1))
        a = self.arrays
        q, W = _host(a.q).astype(np.float64), _host(a.W).astype(np.float64)
        s2 = _host(a.senses2)
        lb, ub = _host(a.lb2).astype(np.float64), \
            _host(a.ub2).astype(np.float64)
        pis, slacks = [], []
        val_pool = (duals @ H[home].T).max(axis=0)     # argmax value now
        for j, s_idx in enumerate(home):
            try:
                obj, _, pi = solve_lp_host(q, W, H[s_idx], s2, lb, ub)
            except RuntimeError:
                continue                      # infeasible at this x: skip
            pis.append(pi)
            slacks.append(obj - val_pool[j])
        if not pis:
            return none
        out = push_duals(
            state.duals, state.duals_rounded, state.n_duals,
            torch.as_tensor(np.stack(pis), dtype=dt, device=self.device),
            state.duals_dropped, sig_bits=self.config.dual_sig_bits,
            score=state.duals_score)
        self.state = dataclasses.replace(
            state, duals=out[0], duals_rounded=out[1], n_duals=out[2],
            duals_dropped=out[3], duals_score=out[4])
        return {"n_solved": len(pis), "n_new": int(out[2]) - nd,
                "mean_slack": float(np.mean(slacks)),
                "max_slack": float(np.max(slacks))}

    def select_decision(self, candidates: Dict, n_samples: int = 16384,
                        seed: int = 31000, batch: int = 4096) -> Dict:
        """Pick the cheapest first-stage decision among ``candidates``
        ({name: x}) on one shared stratified panel (common random
        numbers), each candidate first projected onto the first-stage
        polytope. The winner's panel estimate is optimistically biased:
        re-evaluate it on an independent panel for the reported bound.

        ``batch`` is 4096 here (the reference: 8192), the panel size the
        MC path's kernels are planned and checked for; under 8 batches
        both give the same per-element interval.

        Returns {"name", "x", "table": {name: (mean, half_width,
        projection_distance)}}.
        """
        table = {}
        best = None
        for name, x in candidates.items():
            xp, moved = project_first_stage(self.inst.arrays,
                                            np.asarray(x, np.float64))
            mean, hw, _ = self.evaluate_ci(
                x=xp, min_samples=n_samples, max_samples=n_samples,
                seed=seed, batch=batch, sampling="stratified")
            table[name] = (mean, hw, float(moved))
            if best is None or mean < best[2]:
                best = (name, xp, mean)
        return {"name": best[0], "x": best[1], "table": table}

    def _warmstart_pool(self) -> Optional[np.ndarray]:
        """Live dual-vertex pool [n_duals, m2] (f64, host) or None; on a
        mesh the pool gathered from its shards."""
        n_duals = int(self.state.n_duals)
        if n_duals <= 0:
            return None
        if self.mesh is not None and self.mesh.dual_axis is not None:
            duals = to_host(self.state.duals, self.mesh,
                            self.mesh.dual_axis)
        else:
            duals = _host(self.state.duals)
        return np.asarray(duals[:n_duals], np.float64)

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

    def _recourse_objs(self, H: torch.Tensor, Q=None, obj0=None,
                       valid0=None) -> np.ndarray:
        """Recourse objectives for an RHS panel, certified per element:
        elements the first solve could not certify to ``valid_tol`` walk
        the escalation ladder — a pool-warm-started re-solve, then an f64
        re-solve (the f64 instance of the same kernel on the card), then
        the exact host solver. With ``obj0`` / ``valid0`` (a solve of this
        panel that already ran) only its uncertified residue walks the
        ladder. On a mesh each rank solves its row block of the panel
        (``place_batch``), cold as in the reference, and the values and
        their validity are gathered; every rank then walks the ladder for
        the whole residue."""
        dev = self.device
        dt = self.config.jdtype
        pdhg = self.config.pdhg
        B = H.shape[0]
        with span("driver.panel", rows=B) as panel:
            Qn = None if Q is None else np.asarray(_host(Q), np.float64)
            with span("ladder.first", rows=B, bucket=B) as step:
                pool = self._warmstart_pool()
                if obj0 is not None:
                    if self.mesh is not None:
                        raise ValueError("solve reuse is a single-device "
                                         "path: it does not run on a mesh")
                    vals = np.array(_host(obj0), np.float64)
                    valid = _host(valid0)
                elif self.mesh is not None:
                    obj, _, _, stats = solve_batch(
                        self.prep_sub, place_batch(H, self.mesh), pdhg,
                        Q=None if Q is None else place_batch(Q, self.mesh))
                    vals = to_host(obj, self.mesh).astype(np.float64)[:B]
                    valid = to_host(stats["pdhg_valid"], self.mesh)[:B]
                else:
                    L0 = None
                    if pool is not None \
                            and not self.inst.scenario_model.has_cost:
                        pool_t = torch.as_tensor(pool, dtype=dt, device=dev)
                        L0 = pool_t[torch.argmax(pool_t @ H.to(dt).T, dim=0)]
                    obj, _, _, stats = solve_batch(self.prep_sub, H, pdhg,
                                                   L0=L0, Q=Q)
                    vals = np.array(_host(obj), np.float64)
                    valid = _host(stats["pdhg_valid"])
                bad = np.flatnonzero(~valid)
                step.set(certified=B - bad.size)
            panel.set(first=B - bad.size)
            Hn = np.asarray(_host(H), np.float64)
            if bad.size:
                bucket = max(256, 1 << (int(bad.size) - 1).bit_length())
                with span("ladder.resolve", rows=bad.size,
                          bucket=bucket) as step:
                    idx = np.pad(bad, (0, bucket - bad.size), mode="edge")
                    Hb = torch.as_tensor(Hn[idx], dtype=dt, device=dev)
                    Qb = None if Qn is None else torch.as_tensor(
                        Qn[idx], dtype=dt, device=dev)
                    L0 = None
                    if pool is not None:
                        L0 = torch.as_tensor(pool[np.argmax(
                            pool @ Hn[idx].T, axis=0)], dtype=dt, device=dev)
                    obj_r, Y_r, Pi_r, st_r = solve_batch(
                        self.prep_sub, Hb, pdhg, L0=L0, Q=Qb)
                    fixed = _host(st_r["pdhg_valid"])[:bad.size]
                    vals[bad[fixed]] = np.asarray(
                        _host(obj_r), np.float64)[:bad.size][fixed]
                    rem_pos = np.flatnonzero(~fixed)
                    bad = bad[~fixed]
                    step.set(certified=int(fixed.sum()))
                panel.set(resolve=int(fixed.sum()))
                if bad.size:
                    # f64 escalation, warm-started from the f32 iterate
                    bucket2 = max(256,
                                  1 << (int(bad.size) - 1).bit_length())
                    with span("ladder.f64", rows=bad.size,
                              bucket=bucket2) as step:
                        idx2 = np.pad(bad, (0, bucket2 - bad.size),
                                      mode="edge")
                        pos2 = np.pad(rem_pos, (0, bucket2 - rem_pos.size),
                                      mode="edge")
                        f8 = torch.float64
                        Y64 = Y_r.to(f8)[torch.as_tensor(pos2, device=dev)]
                        P64 = Pi_r.to(f8)[torch.as_tensor(pos2, device=dev)]
                        cfg64 = dataclasses.replace(
                            pdhg, max_iters=min(pdhg.max_iters, 20_000))
                        obj2, _, _, st2 = solve_batch(
                            self._prep_sub64,
                            torch.as_tensor(Hn[idx2], dtype=f8, device=dev),
                            cfg64, Y0=Y64, L0=P64,
                            Q=None if Qn is None else torch.as_tensor(
                                Qn[idx2], dtype=f8, device=dev))
                        fixed2 = _host(st2["pdhg_valid"])[:bad.size]
                        vals[bad[fixed2]] = np.asarray(
                            _host(obj2), np.float64)[:bad.size][fixed2]
                        bad = bad[~fixed2]
                        step.set(certified=int(fixed2.sum()))
                    panel.set(f64=int(fixed2.sum()))
            if bad.size:
                with span("ladder.host", rows=bad.size, bucket=0,
                          certified=bad.size):
                    a = self.arrays
                    q = np.asarray(_host(a.q), np.float64)
                    W = np.asarray(_host(a.W), np.float64)
                    s2 = _host(a.senses2)
                    lb = np.asarray(_host(a.lb2), np.float64)
                    ub = np.asarray(_host(a.ub2), np.float64)
                    for b in bad:
                        try:
                            vals[b], _, _ = solve_lp_host(
                                q if Qn is None else Qn[b], W, Hn[b], s2,
                                lb, ub)
                        except RuntimeError as e:
                            raise RuntimeError(
                                f"recourse LP infeasible/unsolvable at the "
                                f"evaluated x for scenario row {b} (is x "
                                f"first-stage feasible?): {e}") from e
                    self.host_fallback_count += int(bad.size)
                panel.set(host=bad.size)
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

    def _mc_values(self, x, gen: torch.Generator, b: int,
                   sampling: str) -> np.ndarray:
        """Certified recourse values of one b-row MC panel at x."""
        deltas = sample_deltas(gen, self.inst.scenario_model, b,
                               method=sampling)
        H = _scenario_rhs(self.arrays, self.inst.scenario_model, deltas, x)
        return self._recourse_objs(H, Q=self._cost_panel(deltas))

    def evaluate(self, x=None, n_samples: int = 10_000, seed: int = 123,
                 batch: int = 4096, sampling: str = "iid") -> float:
        """Monte-Carlo upper-bound estimate at x; ``sampling`` in {"iid",
        "antithetic", "stratified"} picks the scheme of each batch."""
        x = self._eval_point(x)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        total = 0.0
        done = 0
        while done < n_samples:
            b = min(batch, n_samples - done)
            total += float(self._mc_values(x, gen, b, sampling).sum())
            done += b
        first = float(self.arrays.c @ x)
        return (first + total / n_samples) * self.obj_scale

    def evaluate_ci(self, x=None, confidence: float = 0.95,
                    target_half_width: float = 0.0,
                    min_samples: int = 2048, max_samples: int = 262_144,
                    seed: int = 123, batch: int = 4096,
                    sampling: str = "iid"):
        """Monte-Carlo estimate with a confidence interval. With
        ``target_half_width > 0`` sampling continues in batches until the
        half-width falls below it or ``max_samples`` is reached.

        Under ``sampling`` "antithetic" or "stratified" with at least 8
        full-size batches, the half-width is the Student-t interval over
        the batch means (each batch is an independent variance-reduced
        panel, so it sees the variance reduction); otherwise it is the
        per-element estimator, which is conservative under either scheme.
        The width is floored at ``valid_tol`` relative, the per-element
        solver accuracy. Returns (mean, half_width, n_samples)."""
        from scipy.special import erfinv
        from scipy.stats import t as student_t

        x = self._eval_point(x)
        z = math.sqrt(2.0) * float(erfinv(confidence))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        n = 0
        mean = 0.0
        m2 = 0.0
        batch_means: List[float] = []      # full-size batches only

        def half_width() -> float:
            if sampling != "iid" and len(batch_means) >= 8:
                nb = len(batch_means)
                tq = float(student_t.ppf(0.5 * (1.0 + confidence), nb - 1))
                hw = tq * float(np.std(batch_means, ddof=1)) / math.sqrt(nb)
            else:
                hw = z * math.sqrt(m2 / max(n - 1, 1) / max(n, 1))
            return max(hw, self.config.pdhg.valid_tol * (1.0 + abs(mean)))

        while True:
            stop_at = min_samples if not target_half_width else max_samples
            b = min(batch, stop_at - n)
            if b <= 0:
                break
            vals = self._mc_values(x, gen, b, sampling)
            # Chan et al. parallel-variance merge of the batch's moments
            bn = len(vals)
            bm = float(vals.mean())
            bm2 = float(((vals - bm) ** 2).sum())
            delta = bm - mean
            tot = n + bn
            mean += delta * bn / tot
            m2 += bm2 + delta * delta * n * bn / tot
            n = tot
            if bn == batch:
                batch_means.append(bm)
            if target_half_width and n >= min_samples \
                    and half_width() <= target_half_width:
                break
        hw = half_width()
        first = float(self.arrays.c @ x)
        s_ = self.obj_scale
        return (first + mean) * s_, hw * s_, n


def solve_instance(name_or_dir: str, n_iters: int = 1000,
                   config: SDConfig = SDConfig(), x0=None,
                   seed: int = 0, log_every: int = 100,
                   verbose: bool = True, device="cuda") -> SDSolver:
    """Convenience one-call driver (the reference's script pattern): load
    the instance on ``device`` (the card by default; a host without one
    raises, ``device="cpu"`` runs the plain versions), run ``n_iters``
    iterations, print a line per run chunk and the wall time when
    ``verbose``, return the solver."""
    inst = load_instance(name_or_dir, dtype=config.jdtype, device=device)
    solver = SDSolver(inst, config, x0=x0, seed=seed)

    def cb(i, stats):
        if verbose:
            print(f"[{inst.name}] iter {i}: lb_est={stats['cand_est']:.4f} "
                  f"inc_est={stats['inc_est']:.4f} rho={stats['rho']:.4g} "
                  f"duals={int(stats['n_duals'])} "
                  f"cuts={int(stats['n_cuts_live'])}")

    t0 = time.time()
    solver.run(n_iters, log_every=log_every, callback=cb)
    if verbose:
        print(f"[{inst.name}] {n_iters} iters in {time.time() - t0:.1f}s")
    return solver


class SDReplications(SDSolver):
    """R independent SD replications advanced together
    (``sd_run_replicated``): one PDHG solve over the flattened panel and
    one batched master QP per step.

    ``self.state`` carries a leading replication axis R; instance
    compilation, scaling, projection and evaluation are inherited.
    Replication r draws from a generator seeded ``seed + r``, so
    replication 0 uses a sequential ``SDSolver(seed=seed)``'s seed, but
    lockstep trajectories are not bitwise those of sequential runs: the
    shared panel's per-element restarts and compaction see the merged
    panel, and the cold warm retry of the master is off.
    """

    def __init__(self, inst: Instance, config: SDConfig = SDConfig(),
                 n_replications: int = 2,
                 espec: Optional[EpigraphSpec] = None, x0=None,
                 seed: int = 0, n_epi: int = 1):
        if n_replications < 1:
            raise ValueError(f"n_replications must be >= 1, got "
                             f"{n_replications}")
        super().__init__(inst, config, espec=espec, x0=x0, seed=seed,
                         n_epi=n_epi)
        self.n_replications = n_replications
        self.state = stack_states([self.state] * n_replications)
        self.generators = []
        for r in range(n_replications):
            g = torch.Generator(device=self.device)
            g.manual_seed(seed + r)
            self.generators.append(g)

    def run(self, n_iters: int, log_every: int = 0,
            callback: Optional[Callable[[int, Dict], None]] = None,
            chunk: int = 64) -> Dict:
        """Run n_iters iterations on every replication in chunks with one
        stats readback per chunk; returns the last iteration's stats
        ([R]-shaped entries)."""
        last: Dict = {}
        done = 0
        while done < n_iters:
            n = min(chunk, n_iters - done)
            self.state, packed, keys = sd_run_replicated(
                self.arrays, self.scenario_model, self.espec, self.prep_sub,
                self.state, self.config, n, self.generators)
            acc = self._unscale({k: packed[:, j] for j, k in
                                 enumerate(keys)})
            done += n
            if not np.all(np.isfinite(acc["cand_est"])):
                dump = os.path.abspath("error_state.npz")
                np.savez(dump, **state_to_numpy(self.state))
                raise FloatingPointError(
                    f"non-finite candidate estimate in a replication; "
                    f"stacked state dumped to {dump}")
            if log_every:
                for j in range(n):
                    if int(acc["it"][j, 0]) % log_every == 0:
                        self.history.append({k: acc[k][j] for k in acc})
            last = {k: acc[k][-1] for k in acc}
            if callback:
                callback(done, last)
        return last

    def step(self) -> Dict:
        """One SD iteration on every replication ([R]-shaped stats)."""
        self.state, packed, keys = sd_run_replicated(
            self.arrays, self.scenario_model, self.espec, self.prep_sub,
            self.state, self.config, 1, self.generators)
        return self._unscale({k: packed[0, j] for j, k in enumerate(keys)})

    def _warmstart_pool(self) -> Optional[np.ndarray]:
        """Union of every replication's live dual vertices: the MC retry
        evaluates arbitrary x (the compromise decision), so any
        replication's vertex is an equally valid warm-start candidate."""
        n_duals = _host(self.state.n_duals)                # [R]
        if not n_duals.max(initial=0) > 0:
            return None
        duals = np.asarray(_host(self.state.duals), np.float64)
        return np.concatenate([duals[r, :int(n_duals[r])]
                               for r in range(len(n_duals))])

    @property
    def states(self) -> List[SDState]:
        """Per-replication states (for ``compromise_decision``)."""
        return [state_at(self.state, r) for r in range(self.n_replications)]

    def certified_lower_bound(self, confidence: float = 0.95,
                              method: str = "ef",
                              polish_rounds: int = 24,
                              gap_tol: float = 1e-4,
                              extra_scenarios: int = 0,
                              antithetic_reps: bool = False,
                              seed: int = 9000, **kw) -> Dict:
        """Student-t confidence lower bound on the true optimum from one
        deterministic bound per replication (sd/lower_bound.py):

          "ef"        (default) one extensive-form solve per replication,
                      all R batched on the device, and the aggregate dual
                      cut's exact minimum (``saa_ef_bound``);
          "polish"    level-bundle rounds on the certification streams
                      (``saa_polish``, ``polish_rounds``, ``gap_tol``);
          "ef_polish" the polish over the same streams (same seed), its
                      cuts merged into the EF bound model;
          "model"     the SD run's final cut-model minimum alone.

        ``kw`` goes to the route (``fresh_scenarios``, ``fresh_sampling``;
        the polish's ``level_lambda`` / ``qp_rows_cap``).
        ``antithetic_reps=True`` (fresh streams, even R, not the model
        route) certifies replication 2k+1 on the complement of 2k's stream
        and takes the interval over the R/2 pair means
        (``lb_pair_means``); ``lb_per_rep`` keeps the R per-replication
        bounds, as every other per-replication array does.

        Returns lb_cert / lb_mean / lb_half_width / lb_per_rep and the
        route's diagnostics."""
        if method not in ("ef", "polish", "ef_polish", "model"):
            raise ValueError(f"unknown certification method {method!r}")
        if antithetic_reps:
            if kw.get("fresh_scenarios", 0) <= 0:
                raise ValueError("antithetic_reps requires fresh_scenarios "
                                 "> 0 (it pairs fresh certification "
                                 "streams)")
            if method == "model":
                raise ValueError("antithetic_reps does not apply to the "
                                 "model route, which certifies the SD "
                                 "streams themselves")
            if self.n_replications % 2:
                raise ValueError(f"antithetic_reps needs an even number of "
                                 f"replications, got {self.n_replications}")
            kw["fresh_pairing"] = "antithetic"

        def aggregate(per_rep):
            out = t_lower_bound(per_rep, confidence,
                                pair_means=antithetic_reps)
            if antithetic_reps:
                out["lb_pair_means"] = out["lb_per_rep"]
                out["lb_per_rep"] = np.asarray(per_rep, np.float64)
            return out

        if method == "model" or (method == "polish" and polish_rounds <= 0):
            return certified_lower_bound(
                self.arrays, self.espec, self.states,
                obj_scale=self.obj_scale, confidence=confidence)
        polish_kw = {k: v for k, v in kw.items()
                     if k in ("fresh_scenarios", "fresh_sampling",
                              "fresh_pairing", "level_lambda",
                              "qp_rows_cap")}
        pol = None
        if method in ("polish", "ef_polish"):
            pol = saa_polish(
                self.arrays, self.scenario_model, self.espec,
                self.prep_sub, self.states, self.config,
                obj_scale=self.obj_scale, max_rounds=polish_rounds,
                gap_tol=gap_tol, extra_scenarios=extra_scenarios,
                seed=seed, **polish_kw)
        if method == "polish":
            out = aggregate(pol["lb_per_rep"])
            out["saa_ub_per_rep"] = pol["saa_ub_per_rep"]
            out["polish_rounds"] = pol["rounds"]
            out["polish_gap_per_rep"] = pol["gap_per_rep"]
            out["polish_round_seconds"] = pol["round_seconds"]
            out["dual_infeas_per_rep"] = pol["dual_infeas_per_rep"]
            out["n_scenarios"] = pol["n_scenarios"]
            return out
        ef_kw = {k: v for k, v in kw.items()
                 if k not in ("level_lambda", "qp_rows_cap")}
        if pol is not None:
            # the bundle cuts patch the single aggregate EF cut's slope
            # dip away from its argmin
            ef_kw["extra_cuts"] = pol["cuts_per_rep"]
        ef = saa_ef_bound(self.arrays, self.scenario_model, self.espec,
                          self.states, self.config,
                          obj_scale=self.obj_scale,
                          extra_scenarios=extra_scenarios, seed=seed,
                          **ef_kw)
        out = aggregate(ef["lb_per_rep"])
        for k, v in ef.items():
            if k != "lb_per_rep":
                out[k] = v
        if pol is not None:
            out["polish_lb_per_rep"] = pol["lb_per_rep"]
            out["polish_rounds"] = pol["rounds"]
            out["polish_round_seconds"] = pol["round_seconds"]
        return out

    def solve_to_certified_gap(
            self, target_gap: float, max_iters: int,
            certify_every: int = 0, method: str = "auto",
            confidence: float = 0.95, compromise_rho: float = 1.0,
            min_ub_samples: int = 8192, max_ub_samples: int = 262_144,
            ub_batch: int = 8192, seed: int = 7000,
            verbose: bool = False, **cert_kw) -> Dict:
        """Run SD until the certified optimality gap crosses
        ``target_gap``.

        Every ``certify_every`` iterations (default: four looks across
        ``max_iters``) the loop takes the compromise decision and its
        stratified Monte-Carlo bound (``min_ub_samples``, resampled up to
        ``max_ub_samples`` while the half-width exceeds a quarter of the
        target gap), certifies a lower bound by the free model route
        first, escalates to ``method`` ("auto": "polish" for n1 <= 32,
        else "ef"; ``cert_kw`` goes there) only when the model route
        misses, and stops once ((ub + hw) - (lb_mean - lb_hw)) / |ub + hw|
        <= target_gap. Round k uses the seeds ``seed + 1000 k`` (+1 for
        the resample, +2 for the escalated route).

        The stopping rule looks at the data up to L = ceil(max_iters /
        certify_every) times, so the confidence is split over the planned
        looks: each look's upper-bound interval is taken at 1 - (1 -
        confidence) / L (``confidence_per_look``), and its lower bound
        too, unless the look may escalate: then it takes the better of
        two lower bounds, so each of the two routes gets half the lower
        bound's share, 1 - (1 - confidence) / (2 L)
        (``lb_confidence_per_look``). By the union bound over the looks
        and every interval a look reads, the certified gap at the look
        that stops holds at ``confidence`` overall; the resampled upper
        bound's sequential sampling counts at its nominal level.

        Returns ``stopped``, ``iters``, ``target_gap``, ``confidence``,
        ``looks``, ``confidence_per_look``, ``lb_confidence_per_look``,
        ``time_to_certified_gap_s``
        (None when the target was not reached), the stopping round's
        ``route``, ``lb_cert`` / ``lb_mean`` / ``lb_half_width``,
        ``compromise_mc_ub`` (+ ``_half_width``), ``mc_ub_samples``,
        ``cert_gap``, ``x_compromise`` and ``rounds`` (one record per
        look). Raises ValueError for ``target_gap <= 0``.
        """
        if not target_gap > 0.0:
            raise ValueError(f"target_gap must be > 0, got {target_gap}")
        if not certify_every:
            certify_every = max(1, max_iters // 4)
        if method == "auto":
            # the level bundle closes on low-dimensional first stages; EF
            # dual certificates win in high dimension where it stalls
            method = "polish" if self.inst.n1 <= 32 else "ef"
        looks = max(1, math.ceil(max_iters / certify_every))
        conf = 1.0 - (1.0 - confidence) / looks
        # the better of two lower bounds fails when either does
        conf_lb = conf if method == "model" else \
            1.0 - (1.0 - confidence) / (2 * looks)
        t_start = time.time()
        rounds: List[Dict] = []
        done = 0
        while True:
            n = min(certify_every, max_iters - done)
            if n > 0:
                self.run(n)
                done += n
            x_comp, _ = compromise_decision(
                self.inst, self.states, self.especs, rho=compromise_rho,
                qp_config=self.config.qp, obj_scale=self.obj_scale)
            rseed = seed + 1000 * len(rounds)
            ub, hw, n_ub = self.evaluate_ci(
                x=x_comp, min_samples=min_ub_samples,
                max_samples=min_ub_samples, seed=rseed, batch=ub_batch,
                sampling="stratified", confidence=conf)
            # a quarter of the target gap keeps the sampling error a minor
            # term of the bracket
            tgt_hw = 0.25 * target_gap * max(abs(ub), 1e-9)
            if hw > tgt_hw and max_ub_samples > min_ub_samples:
                ub, hw, n_ub = self.evaluate_ci(
                    x=x_comp, target_half_width=tgt_hw,
                    min_samples=min_ub_samples,
                    max_samples=max_ub_samples, seed=rseed + 1,
                    batch=ub_batch, sampling="stratified", confidence=conf)

            def gap_of(cert):
                return ((ub + hw) - (cert["lb_mean"] - cert["lb_half_width"])
                        ) / max(abs(ub + hw), 1e-9)

            cert = certified_lower_bound(
                self.arrays, self.espec, self.states,
                obj_scale=self.obj_scale, confidence=conf_lb)
            route = "model"
            gap = gap_of(cert)
            if gap > target_gap and method != "model":
                cert_esc = self.certified_lower_bound(
                    confidence=conf_lb, method=method, seed=rseed + 2,
                    **cert_kw)
                gap_esc = gap_of(cert_esc)
                if gap_esc < gap:
                    cert, gap, route = cert_esc, gap_esc, method
            rec = {"it": done, "route": route,
                   "wall_s": round(time.time() - t_start, 2),
                   "lb_cert": float(cert["lb_cert"]),
                   "lb_mean": float(cert["lb_mean"]),
                   "lb_half_width": float(cert["lb_half_width"]),
                   "compromise_mc_ub": float(ub),
                   "compromise_mc_ub_half_width": float(hw),
                   "mc_ub_samples": int(n_ub),
                   "cert_gap": float(gap)}
            rounds.append(rec)
            if verbose:
                print(f"[certify] iter {done}: gap={gap:.5f} "
                      f"({route}; lb_cert={cert['lb_cert']:.6g} "
                      f"ub={ub:.6g}+-{hw:.3g}) target={target_gap:g}",
                      file=sys.stderr, flush=True)
            stopped = gap <= target_gap
            if stopped or done >= max_iters:
                out = dict(rec)
                out.update({
                    "stopped": stopped,
                    "iters": done,
                    "target_gap": target_gap,
                    "confidence": confidence,
                    "looks": looks,
                    "confidence_per_look": conf,
                    "lb_confidence_per_look": conf_lb,
                    "time_to_certified_gap_s":
                        rec["wall_s"] if stopped else None,
                    "x_compromise": np.asarray(x_comp),
                    "rounds": rounds,
                })
                return out

    @property
    def especs(self) -> List[EpigraphSpec]:
        return [self.espec] * self.n_replications

    @property
    def x_incumbents(self) -> np.ndarray:
        return _host(self.state.x_incumbent)               # [R, n1]

    @property
    def lower_estimates(self) -> np.ndarray:
        return _host(self.state.cand_est) * self.obj_scale

    # singular accessors are ambiguous on a batch: point at the plurals
    @property
    def x_incumbent(self) -> np.ndarray:
        raise AttributeError("SDReplications has R incumbents: use "
                             ".x_incumbents [R, n1]")

    @property
    def lower_estimate(self) -> float:
        raise AttributeError("SDReplications has R estimates: use "
                             ".lower_estimates [R]")
