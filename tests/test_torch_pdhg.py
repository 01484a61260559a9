"""The port's batched PDHG solver (sqlp_tpu_torch/ops/pdhg.py) and its
Halpern and restart-to-average rounds (ops/cuda/pdhg_kernel.py, plain
versions on the CPU) held against the JAX package's solve_batch (XLA loop,
float64) on the same numpy right-hand-side panels, plus the HiGHS
oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.ops.pdhg import prepare_lp as jax_prepare_lp
from sqlp_tpu.ops.pdhg import solve_batch as jax_solve_batch
from sqlp_tpu_torch.config import PDHGConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.routines import solve_lp_host
from sqlp_tpu_torch.ops.cuda.pdhg_kernel import (pdhg_average_round,
                                                 pdhg_average_round_ref,
                                                 pdhg_halpern_round,
                                                 pdhg_halpern_round_ref)
from sqlp_tpu_torch.ops.pdhg import (PREPARED_FIELDS, prepare_lp,
                                     prepared_lp_from_numpy, solve_batch)

torch.set_num_threads(1)

# first-stage points with feasible recourse (lands needs capacity)
_X = {"lands": 5.0, "transship": 0.0, "ssn": 0.0}


def numpy_panel(inst, B, x, seed):
    """[B, m2] RHS panel h = r - T x + scatter(effective deltas), with the
    scenario values drawn by numpy from the instance's marginals."""
    m = inst.scenario_model
    rng = np.random.default_rng(seed)
    dist = m.dist_type.numpy()
    vals = m.values.double().numpy()
    R = len(dist)
    v = np.empty((B, R))
    for k in range(R):
        if dist[k] == 0:
            v[:, k] = rng.choice(vals[k], size=B)
        elif dist[k] == 1:
            v[:, k] = float(m.mean[k]) + float(m.std[k]) * rng.standard_normal(B)
        else:
            v[:, k] = float(m.left[k]) + float(m.width[k]) * rng.random(B)
    d = v - m.base.double().numpy()
    is_rhs = m.rv_is_rhs.numpy()
    eff = np.where(is_rhs, d, -d * x[m.rv_col.numpy()])
    H = np.zeros((B, inst.m2))
    np.add.at(H.T, m.rv_row.numpy(), eff.T)
    a = inst.arrays
    return (a.r.double().numpy() - a.T.double().numpy() @ x)[None, :] + H


def _both(name, B, seed, per_el_q=False):
    port = load_instance(name, dtype=torch.float64, device="cpu")
    ref = jax_load_instance(name, dtype=jnp.float64)
    x = np.full(port.n1, _X[name])
    H = numpy_panel(port, B, x, seed)
    Q = None
    if per_el_q:
        rng = np.random.default_rng(seed + 1)
        Q = port.arrays.q.numpy()[None, :] * (1.0 + 0.2 * rng.random(
            (B, port.n2)))
    a = port.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    ja = ref.arrays
    jlp = jax_prepare_lp(ja.W, ja.senses2, ja.q, ja.lb2, ja.ub2)
    return port, lp, jlp, H, Q


def _close(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * (1.0 + np.abs(b).max()))


@pytest.mark.parametrize("name", ["lands", "transship", "ssn"])
def test_prepare_lp_matches_jax(name):
    """Ruiz scaling and the power-iteration step size: same fields to
    1e-12 relative (64 power iterations of float64 mat-vecs); and
    prepared_lp_from_numpy carries the JAX PreparedLP over bitwise."""
    _, lp, jlp, _, _ = _both(name, 1, 0)
    carried = prepared_lp_from_numpy({f: getattr(jlp, f)
                                      for f in PREPARED_FIELDS},
                                     device="cpu")
    for f in PREPARED_FIELDS:
        a, b = getattr(lp, f), getattr(jlp, f)
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      np.asarray(b))
        if f == "is_eq":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a.numpy(), b, 1e-12)


@pytest.mark.parametrize("per_el_q", [False, True], ids=["shared_q", "per_el_q"])
@pytest.mark.parametrize("name,B", [("lands", 8), ("transship", 8),
                                    ("ssn", 16)])
def test_one_halpern_round_matches_jax(name, B, per_el_q):
    """solve_batch with max_iters == restart_every runs exactly one round,
    so the returned Y / Pi are that round's candidate T(z) (unscaled).
    Tolerance 1e-10 relative: 80 float64 steps whose only difference is
    the BLAS reduction order."""
    _, lp, jlp, H, Q = _both(name, B, seed=3, per_el_q=per_el_q)
    cfg = dict(tol=1e-12, max_iters=80, restart_every=80)
    jobj, jY, jPi, jst = jax_solve_batch(
        jlp, jnp.asarray(H), JPDHGConfig(**cfg),
        Q=None if Q is None else jnp.asarray(Q))
    obj, Y, Pi, st = solve_batch(lp, torch.as_tensor(H), PDHGConfig(**cfg),
                                 Q=None if Q is None else torch.as_tensor(Q))
    assert st["pdhg_rounds"] == int(jst["pdhg_rounds"]) == 1
    _close(Y.numpy(), jY, 1e-10)
    _close(Pi.numpy(), jPi, 1e-10)
    _close(obj.numpy(), jobj, 1e-10)
    _close(st["pdhg_err"].numpy(), jst["pdhg_err"], 1e-8)


def test_kernel_wrapper_cpu_is_plain_version():
    """On CPU tensors the wrappers are exactly the plain versions
    (bitwise), and a non-CPU, non-CUDA device is refused."""
    _, lp, _, H, _ = _both("lands", 4, 1)
    B = H.shape[0]
    ht = torch.as_tensor(H) * (lp.flip * lp.row_scale)[None, :]
    lb = torch.clamp(lp.lb, min=-1e30)
    ub = torch.clamp(lp.ub, max=1e30)
    tau = torch.full((B,), float(lp.step))
    Y = torch.zeros((B, lp.n), dtype=torch.float64)
    L = torch.zeros((B, lp.m), dtype=torch.float64)
    kh = torch.zeros(B, dtype=torch.float64)
    args = (lp.K, lp.q, lb, ub, lp.is_eq, ht, tau.double(), tau.double(), Y,
            L, kh, Y, L, 7)
    for a, b in zip(pdhg_halpern_round(*args), pdhg_halpern_round_ref(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pdhg_halpern_round(lp.K.to("meta"), *args[1:])
    avg = args[:10] + (7,)
    for a, b in zip(pdhg_average_round(*avg), pdhg_average_round_ref(*avg)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pdhg_average_round(lp.K.to("meta"), *avg[1:])


def _jax_average_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, n):
    """The JAX package's restart-to-average inner loop
    (sqlp_tpu/ops/pdhg.py:330-340), written out in jnp."""
    qrow = q[None, :] if q.ndim == 1 else q
    tau, sig = tau[:, None], sig[:, None]

    def body(_, carry):
        Y, L, Ys, Ls, cnt = carry
        G = qrow - L @ K
        Y1 = jnp.clip(Y - tau * G, lb, ub)
        S = ht - (2.0 * Y1 - Y) @ K.T
        Lr = L + sig * S
        L1 = jnp.where(is_eq[None, :], Lr, jnp.maximum(Lr, 0.0))
        return Y1, L1, Ys + Y1, Ls + L1, cnt + 1.0

    init = (Y, L, jnp.zeros_like(Y), jnp.zeros_like(L),
            jnp.zeros((), Y.dtype))
    Y, L, Ys, Ls, cnt = jax.lax.fori_loop(0, n, body, init)
    return Y, L, Ys / cnt, Ls / cnt


@pytest.mark.parametrize("per_el_q", [False, True], ids=["shared_q", "per_el_q"])
def test_average_round_ref_matches_jax_loop(per_el_q):
    """One 80-step round of the plain version against the JAX loop on ssn
    operands, from a mid-solve point. Tolerance 1e-12 relative: the same
    float64 operations, only the BLAS reduction order differs."""
    _, lp, _, H, Q = _both("ssn", 6, seed=4, per_el_q=per_el_q)
    B = H.shape[0]
    ht = torch.as_tensor(H) * (lp.flip * lp.row_scale)[None, :]
    lb = torch.clamp(lp.lb, min=-1e30)
    ub = torch.clamp(lp.ub, max=1e30)
    q = lp.q if Q is None else torch.as_tensor(Q) * lp.col_scale[None, :]
    rng = np.random.default_rng(2)
    tau = torch.as_tensor(float(lp.step) * rng.uniform(0.5, 2.0, B))
    sig = torch.as_tensor(float(lp.step) * rng.uniform(0.5, 2.0, B))
    Y = torch.clamp(torch.zeros((B, lp.n), dtype=torch.float64), lb, ub)
    L = torch.zeros((B, lp.m), dtype=torch.float64)
    args = [lp.K, q, lb, ub, lp.is_eq, ht, tau, sig]
    Y, L, _, _ = pdhg_average_round_ref(*args, Y, L, 40)
    out = pdhg_average_round(*args, Y, L, 80)
    ref = _jax_average_round(*(jnp.asarray(a.numpy()) for a in args),
                             jnp.asarray(Y.numpy()), jnp.asarray(L.numpy()),
                             80)
    for o, r in zip(out, ref):
        _close(o.numpy(), r, 1e-12)


@pytest.mark.parametrize("budget", ["one_round", "to_tol"])
@pytest.mark.parametrize("name,B", [("lands", 8), ("transship", 8),
                                    ("ssn", 4)])
def test_average_scheme_matches_jax(name, B, budget):
    """solve_batch(scheme="average") against the JAX one: exactly one
    round (max_iters 80), and to tol 1e-9 (capped at 4000 iterations).
    Objectives, Y and Pi agree to 1e-10 relative and the round counts
    are equal: the same restarts in float64, only the BLAS reduction
    order differs."""
    _, lp, jlp, H, _ = _both(name, B, seed=6)
    cfg = dict(scheme="average", tol=1e-9,
               max_iters=80 if budget == "one_round" else 4000)
    jobj, jY, jPi, jst = jax_solve_batch(jlp, jnp.asarray(H),
                                         JPDHGConfig(**cfg))
    obj, Y, Pi, st = solve_batch(lp, torch.as_tensor(H), PDHGConfig(**cfg))
    assert st["pdhg_rounds"] == int(jst["pdhg_rounds"])
    if budget == "one_round":
        assert st["pdhg_rounds"] == 1
    _close(obj.numpy(), jobj, 1e-10)
    _close(Y.numpy(), jY, 1e-10)
    _close(Pi.numpy(), jPi, 1e-10)
    np.testing.assert_array_equal(st["pdhg_done"].numpy(),
                                  np.asarray(jst["pdhg_done"]))


@pytest.mark.parametrize("name,B", [("lands", 8), ("transship", 8)])
def test_full_solve_matches_jax_and_highs(name, B):
    """Solves to tolerance: objectives against the JAX solve (1e-8
    relative: same restarts in float64) and HiGHS (1e-6: the solve's own
    1e-9 KKT tolerance, relative), pi'h strong duality against HiGHS
    (1e-6), the JuMP dual sign convention, and the same round count."""
    port, lp, jlp, H, _ = _both(name, B, seed=0)
    jobj, _, jPi, jst = jax_solve_batch(
        jlp, jnp.asarray(H), JPDHGConfig(tol=1e-9, max_iters=100_000))
    obj, _, Pi, st = solve_batch(lp, torch.as_tensor(H),
                                 PDHGConfig(tol=1e-9, max_iters=100_000))
    assert bool(st["pdhg_converged"]) and bool(jst["pdhg_converged"])
    assert abs(st["pdhg_rounds"] - int(jst["pdhg_rounds"])) <= 1
    _close(obj.numpy(), jobj, 1e-8)
    a = port.arrays
    senses = a.senses2.numpy()
    Pi = Pi.numpy()
    assert np.all(Pi[:, senses == 1] >= -1e-7)
    assert np.all(Pi[:, senses == -1] <= 1e-7)
    for b in range(B):
        ref_obj, _, _ = solve_lp_host(a.q.numpy(), a.W.numpy(), H[b],
                                      senses, a.lb2.numpy(), a.ub2.numpy())
        assert float(obj[b]) == pytest.approx(ref_obj, rel=1e-6, abs=1e-6)
        assert float(Pi[b] @ H[b]) == pytest.approx(ref_obj, rel=1e-6,
                                                    abs=1e-6)


def test_lands_subgradient_golden():
    """beta = -T' pi at x = (2, 3, 4, 5), demand 5: the port's beta equals
    the JAX solve's (1e-6: both converge to 1e-10 on a dual-degenerate
    LP along the same path) and is a valid subgradient of Q, like the
    reference's golden vertex [-11, -6, -19, 0] (test/sgd_example.jl:28),
    which is one point of the same optimal dual face."""
    port = load_instance("lands", dtype=torch.float64, device="cpu")
    ref = jax_load_instance("lands", dtype=jnp.float64)
    a = port.arrays
    T = a.T.numpy()
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    ja = ref.arrays
    jlp = jax_prepare_lp(ja.W, ja.senses2, ja.q, ja.lb2, ja.ub2)
    row = int(port.scenario_model.rv_row[0])
    golden = np.array([-11.0, -6.0, -19.0, 0.0])

    def solve(xv):
        h = a.r.numpy() - T @ xv
        h[row] = 5.0
        cfg = dict(tol=1e-10, max_iters=200_000)
        obj, _, Pi, st = solve_batch(lp, torch.as_tensor(h[None, :]),
                                     PDHGConfig(**cfg))
        assert bool(st["pdhg_converged"])
        _, _, jPi, _ = jax_solve_batch(jlp, jnp.asarray(h[None, :]),
                                       JPDHGConfig(**cfg))
        beta = -T.T @ Pi[0].numpy()
        _close(beta, -T.T @ np.asarray(jPi[0]), 1e-6)
        return float(obj[0]), beta

    x = np.array([2.0, 3.0, 4.0, 5.0])
    Qx, beta = solve(x)
    rng = np.random.default_rng(0)
    for _ in range(3):
        xp = x + rng.uniform(0.0, 2.0, size=4)
        Qxp, _ = solve(xp)
        assert Qxp >= Qx + beta @ (xp - x) - 1e-5
        assert Qxp >= Qx + golden @ (xp - x) - 1e-5


def test_large_panel_runs_compaction_ladder():
    """B = 2048 reaches the compaction ladder (2048 -> 512 -> 256): same
    phase boundaries and certification flags as the JAX solve, objectives
    to 1e-8 relative."""
    _, lp, jlp, H, _ = _both("lands", 2048, seed=5)
    cfg = dict(tol=1e-7, max_iters=20_000)
    jobj, _, _, jst = jax_solve_batch(jlp, jnp.asarray(H), JPDHGConfig(**cfg))
    obj, _, _, st = solve_batch(lp, torch.as_tensor(H), PDHGConfig(**cfg))
    assert len(st["pdhg_phase_rounds"]) == 3
    np.testing.assert_array_equal(st["pdhg_phase_rounds"],
                                  np.asarray(jst["pdhg_phase_rounds"]))
    np.testing.assert_array_equal(st["pdhg_valid"].numpy(),
                                  np.asarray(jst["pdhg_valid"]))
    _close(obj.numpy(), jobj, 1e-8)


@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_cpu_solve_replays_no_graph_and_keeps_the_jax_ladder(scheme):
    """On the CPU no round replays from a CUDA graph: the B = 2048 lands
    solve through the compaction ladder captures and replays nothing and
    counts no kernel launch, and keeps the JAX solve's phase boundaries,
    certification flags and objectives (to 1e-8 relative)."""
    from sqlp_tpu_torch.ops.cuda import pdhg_kernel
    _, lp, jlp, H, _ = _both("lands", 2048, seed=5)
    cfg = dict(tol=1e-7, max_iters=20_000, scheme=scheme)
    jobj, _, _, jst = jax_solve_batch(jlp, jnp.asarray(H), JPDHGConfig(**cfg))
    graphs = dict(pdhg_kernel.graph_counts)
    launches = dict(pdhg_kernel.launches_by_shape)
    obj, _, _, st = solve_batch(lp, torch.as_tensor(H), PDHGConfig(**cfg))
    assert dict(pdhg_kernel.graph_counts) == graphs
    assert dict(pdhg_kernel.launches_by_shape) == launches
    np.testing.assert_array_equal(st["pdhg_phase_rounds"],
                                  np.asarray(jst["pdhg_phase_rounds"]))
    np.testing.assert_array_equal(st["pdhg_valid"].numpy(),
                                  np.asarray(jst["pdhg_valid"]))
    _close(obj.numpy(), jobj, 1e-8)
