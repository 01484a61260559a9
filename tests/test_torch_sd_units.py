"""SD building blocks of the port (sqlp_tpu_torch/sd, ops/crossover.py)
held against the JAX package and the goldens of tests/test_sd_units.py
(the reference's test/sd_test.jl and test/dual_set_test.jl)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.models.routines import solve_problem as jax_solve_problem
from sqlp_tpu.models.smps_tim import Position
from sqlp_tpu.ops.crossover import sharpen_duals as jax_sharpen_duals
from sqlp_tpu.ops.pdhg import prepare_lp as jax_prepare_lp
from sqlp_tpu.ops.pdhg import solve_batch as jax_solve_batch
from sqlp_tpu.sd.cuts import quantized_argmax as jax_quantized_argmax
from sqlp_tpu.sd.dual_pool import push_duals as jax_push_duals
from sqlp_tpu.sd.dual_pool import round_sig_bits as jax_round_sig_bits
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.routines import solve_problem
from sqlp_tpu_torch.ops.crossover import _batched_solve, sharpen_duals
from sqlp_tpu_torch.sd.cuts import (build_sasa_cut, evaluate_epigraph,
                                    quantized_argmax)
from sqlp_tpu_torch.sd.dual_pool import push_duals, round_sig_bits
from sqlp_tpu_torch.sd.master import assemble_master, cut_dual_slice
from sqlp_tpu_torch.sd.state import (default_epigraph_spec, init_state,
                                     master_rows)

from test_torch_pdhg import numpy_panel

torch.set_num_threads(1)
f64 = torch.float64


@pytest.fixture(scope="module")
def lands():
    return load_instance("lands", dtype=f64, device="cpu")


def _empty_pool(D, m, dtype=f64):
    z = torch.zeros((D, m), dtype=dtype)
    i = torch.zeros((), dtype=torch.int32)
    return z, z.clone(), i, i.clone()


# ---------------------------------------------------------------- dual pool

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_round_sig_bits_matches_jax_bitwise(dtype):
    """frexp / ldexp rounding reproduces the JAX function bit for bit
    (tolerance 0, NaN positions included), at zero, at subnormals, at
    halfway points (round half to even) and across the exponent range."""
    info = np.finfo(dtype)
    rng = np.random.default_rng(0)
    x = np.concatenate([
        [0.0, -0.0, 1.0, -1.0, 1.0000000001, -0.4999999999,
         1.0 + 2.0 ** -16, 1.0 + 3 * 2.0 ** -17, 1.0 + 2.0 ** -17,
         float(info.tiny), float(info.tiny) / 8, -float(info.tiny) / 2,
         float(info.smallest_subnormal), 2.0 ** -70, 3.0e5, -7.25e12,
         float(info.max) / 4],
        rng.standard_normal(200) * 10.0 ** rng.integers(-30, 30, 200)
    ]).astype(dtype)
    a = round_sig_bits(torch.as_tensor(x)).numpy()
    b = np.asarray(jax_round_sig_bits(jnp.asarray(x)))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_round_sig_bits_julia_parity():
    """round(x; base=2, sigdigits=16): 1.0000000001 -> 1.0 exactly."""
    r = round_sig_bits(torch.tensor([1.0000000001, 1.0, -0.4999999999, 0.0],
                                    dtype=f64)).numpy()
    assert r[0] == r[1] == 1.0 and r[2] == -0.5 and r[3] == 0.0


def test_dual_pool_dedup_semantics():
    """dual_set_test.jl: 1e-10 perturbations are equal; same 1-norm but
    different elements are distinct; counts grow 1, 1, 2, 3."""
    duals, rounded, n, dropped = _empty_pool(8, 3)
    for vec, expected in [([1.0, 2.0, 3.0], 1), ([1.0000000001, 2.0, 3.0], 1),
                          ([4.0, 5.0, 6.0], 2), ([3.0, 2.0, 1.0], 3)]:
        duals, rounded, n, dropped = push_duals(
            duals, rounded, n, torch.tensor([vec], dtype=f64), dropped)
        assert int(n) == expected
    assert int(dropped) == 0


def test_dual_pool_usage_score_eviction():
    """At capacity the lowest-score vertex is evicted and the fresh vertex
    starts at the live mean (tests/test_sd_units.py golden)."""
    duals = torch.tensor([[1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]], dtype=f64)
    n = torch.tensor(3, dtype=torch.int32)
    dropped = torch.tensor(0, dtype=torch.int32)
    score = torch.tensor([5.0, 0.5, 2.0], dtype=f64)
    duals, rounded, n, dropped, score = push_duals(
        duals, duals.clone(), n, torch.tensor([[9.0, 0, 0]], dtype=f64),
        dropped, score=score)
    assert int(n) == 3 and int(dropped) == 1
    np.testing.assert_allclose(duals[:, 0].numpy(), [1.0, 9.0, 3.0])
    assert float(score[1]) == pytest.approx(2.5)


def test_push_duals_matches_jax_fold():
    """A stream with in-batch duplicates, invalid entries and overflow
    past capacity: pool, rounded copy, counts and scores equal the JAX
    fold exactly (tolerance 0: the same elementwise float64 operations)."""
    rng = np.random.default_rng(1)
    D, m = 6, 5
    base = rng.standard_normal((4, m))
    pis = base[rng.integers(0, 4, 14)] + rng.choice(
        [0.0, 1e-12], size=(14, m))
    pis[[3, 9]] = rng.standard_normal((2, m))
    valid = rng.random(14) > 0.2
    score = rng.random(D)
    t = push_duals(*_empty_pool(D, m)[:3], torch.as_tensor(pis),
                   torch.tensor(0, dtype=torch.int32), valid=torch.as_tensor(valid),
                   score=torch.as_tensor(score))
    j = jax_push_duals(jnp.zeros((D, m)), jnp.zeros((D, m)),
                       jnp.asarray(0, jnp.int32), jnp.asarray(pis),
                       jnp.asarray(0, jnp.int32), valid=jnp.asarray(valid),
                       score=jnp.asarray(score))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ argmax

def test_argmax_picks_first_maximum():
    """torch.argmax returns the first maximum, as jnp.argmax does: the
    quantized pick relies on it for ties."""
    s = torch.tensor([[1.0, 3.0], [3.0, 3.0], [3.0, 1.0]], dtype=f64)
    assert torch.argmax(s, dim=0).tolist() == [1, 0]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_quantized_argmax_ties_match_jax(dtype):
    """Exact ties, near-ties inside the quantum and -inf (dead) rows: the
    port picks the same index as the JAX function (tolerance 0)."""
    rng = np.random.default_rng(2)
    s = rng.standard_normal((40, 64)) * 100.0
    best = s.max(axis=0)
    eps = 1e-4 if dtype == "float32" else 1e-9
    s[5] = best                                   # exact ties
    s[9] = best - 0.1 * eps * (1 + np.abs(best))  # inside the quantum
    s[30:] = -np.inf                              # dead pool rows
    s[:, 7] = -np.inf                             # all-dead column
    s = s.astype(dtype)
    a = quantized_argmax(torch.as_tensor(s)).numpy()
    b = np.asarray(jax_quantized_argmax(jnp.asarray(s)))
    np.testing.assert_array_equal(a, b)
    assert a[7] == 0


# ------------------------------------------------------------- crossover

@pytest.mark.parametrize("name,tol,min_acc", [("lands", 1e-4, 1),
                                              ("transship", 1e-5, 0)])
def test_crossover_matches_jax(name, tol, min_acc):
    """sharpen_duals on first-order duals of a numpy RHS panel: the same
    acceptance pattern and sharpened duals as the JAX crossover
    (1e-8 relative: batched LU solves in float64). Lands' 1e-4 duals are
    interior enough that some roundings pass the acceptance test."""
    port = load_instance(name, dtype=f64, device="cpu")
    ref = jax_load_instance(name, dtype=jnp.float64)
    x = np.full(port.n1, 5.0 if name == "lands" else 0.0)
    H = numpy_panel(port, 12, x, seed=4)
    ja = ref.arrays
    jlp = jax_prepare_lp(ja.W, ja.senses2, ja.q, ja.lb2, ja.ub2)
    _, Y, Pi, _ = jax_solve_batch(jlp, jnp.asarray(H),
                                  JPDHGConfig(tol=tol, max_iters=20_000))
    Y, Pi = np.array(Y), np.array(Pi)
    jP, jacc = jax_sharpen_duals(ja.W, ja.q, ja.senses2, ja.lb2, ja.ub2,
                                 jnp.asarray(H), jnp.asarray(Y),
                                 jnp.asarray(Pi))
    a = port.arrays
    P, acc = sharpen_duals(a.W, a.q, a.senses2, a.lb2, a.ub2,
                           torch.as_tensor(H), torch.as_tensor(Y),
                           torch.as_tensor(Pi))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert int(acc.sum()) >= min_acc
    jP = np.asarray(jP)
    np.testing.assert_allclose(P.numpy(), jP, rtol=1e-8,
                               atol=1e-8 * (1 + np.abs(jP).max()))


def test_batched_solve_singular_gives_nan_not_raise():
    """torch.linalg.solve raises on a singular system; the crossover's
    solve marks that element non-finite instead (what jnp.linalg.solve
    yields and the acceptance test rejects) and solves the others."""
    M = torch.stack([torch.eye(3, dtype=f64), torch.zeros((3, 3), dtype=f64)])
    x = _batched_solve(M, torch.ones((2, 3), dtype=f64))
    assert torch.equal(x[0], torch.ones(3, dtype=f64))
    assert torch.isnan(x[1]).all()


# ---------------------------------------------------------- cuts / master

def _scenario(v):
    return [(Position("RHS", "S2C5"), float(v))]


def _sasa_cut_golden(lands, sp2, solve_problem):
    x1 = np.full(4, 3.0)
    x = np.array([2.0, 3.0, 4.0, 5.0])
    _, _, d5 = solve_problem(sp2, x1, _scenario(5.0))
    _, _, d3 = solve_problem(sp2, x1, _scenario(3.0))
    duals, rounded, n, dropped = _empty_pool(4, lands.m2)
    duals, rounded, n, dropped = push_duals(
        duals, rounded, n, torch.as_tensor(np.array([d5, d3])), dropped)
    base_v = float(lands.scenario_model.base[0])
    deltas = torch.zeros((4, 1), dtype=f64)
    deltas[0, 0], deltas[1, 0] = 3.0 - base_v, 7.0 - base_v
    weights = torch.tensor([1.5, 0.5, 0.0, 0.0], dtype=f64)
    cut = build_sasa_cut(lands.arrays, lands.scenario_model, duals, n,
                         deltas, weights, torch.tensor(2.0, dtype=f64),
                         torch.as_tensor(x))
    r = lands.arrays.r.numpy()
    T = lands.arrays.T.numpy()
    row = int(lands.scenario_model.rv_row[0])
    r1, r2 = r.copy(), r.copy()
    r1[row], r2[row] = 3.0, 7.0
    alpha = 0.75 * d3 @ r1 + 0.25 * d5 @ r2
    beta = 0.75 * (-T.T @ d3) + 0.25 * (-T.T @ d5)
    assert float(cut.alpha) == pytest.approx(alpha, rel=1e-12)
    np.testing.assert_allclose(cut.beta.numpy(), beta, rtol=1e-12)


def test_build_sasa_cut_weighted_golden(lands):
    """Weighted cut assembly (sd_test.jl:207-235): scenarios rhs = 3
    (w = 1.5) and 7 (w = 0.5), duals from the port's exact host solves
    (``solve_problem``, held to the JAX package's in
    tests/test_torch_public_surface.py) at x1 = 3, cut at x = [2, 3, 4, 5];
    1e-12 relative to the hand computation."""
    _sasa_cut_golden(lands, lands.sp2, solve_problem)


def test_build_sasa_cut_weighted_golden_jax_oracle(lands):
    """The same golden with the duals from the JAX package's
    ``solve_problem`` on its own compiled lands."""
    jinst = jax_load_instance("lands", dtype=jnp.float64)
    _sasa_cut_golden(lands, jinst.sp2, jax_solve_problem)


def _epi(cuts, inc, x, total, lb):
    K = 4
    alpha, beta = torch.zeros(K, dtype=f64), torch.zeros((K, 4), dtype=f64)
    mark, live = torch.zeros(K, dtype=f64), torch.zeros(K, dtype=torch.bool)
    for k, (a, b, m) in enumerate(cuts):
        alpha[k], beta[k], mark[k], live[k] = a, torch.tensor(b), m, True
    ia, ib, iv = (0.0, [0.0] * 4, False) if inc is None else (*inc, True)
    t = lambda v: torch.tensor(v, dtype=f64)
    return float(evaluate_epigraph(alpha, beta, mark, live, t(ia), t(ib),
                                   torch.tensor(iv), t(float(total)),
                                   t(float(lb)), t(x)))


def test_evaluate_epigraph_golden():
    """sd_test.jl:189-194: 551 (incumbent cut wins), 141/2 + 100/2, and
    the lower bound below every cut."""
    cut1 = (1.0, [2.0, 3.0, 4.0, 5.0], 1.0)
    cut2 = (6.0, [7.0, 8.0, 9.0, 10.0], 2.0)
    inc = (11.0, [12.0, 13.0, 14.0, 15.0])
    assert _epi([cut1, cut2], inc, [10.0] * 4, 2.0, 0.0) == pytest.approx(551)
    assert _epi([cut1], None, [10.0] * 4, 2.0, 100.0) == pytest.approx(120.5)
    assert _epi([cut1], None, [-1.0] * 4, 2.0, 100.0) == pytest.approx(100.0)


def test_master_cut_row_discount_lb_blending(lands):
    """The 50.5 golden (sd_test.jl:184-187): cut alpha = 1, mark = 1,
    total = 2, lb = 100 gives the row bound 0.5 + 50 = 50.5."""
    cfg = SDConfig(dtype="float64", max_scenarios=8, max_dual_vertices=8,
                   max_cuts=4)
    espec = default_epigraph_spec(1, 0.5, 100.0, dtype=f64, device="cpu")
    state = init_state(lands, espec, cfg, np.zeros(lands.n1))
    state = dataclasses.replace(
        state,
        cut_alpha=state.cut_alpha.index_put((torch.tensor(0), torch.tensor(0)),
                                            torch.tensor(1.0, dtype=f64)),
        cut_beta=state.cut_beta.index_put(
            (torch.tensor(0), torch.tensor(0)),
            torch.tensor([2.0, 3.0, 4.0, 5.0], dtype=f64)),
        cut_mark=state.cut_mark.index_put((torch.tensor(0), torch.tensor(0)),
                                          torch.tensor(1.0, dtype=f64)),
        cut_live=state.cut_live.index_put((torch.tensor(0), torch.tensor(0)),
                                          torch.tensor(True)),
        total_weight=torch.tensor([2.0], dtype=f64))
    p, g, A, l, u, is_eq = assemble_master(lands.arrays, espec, state,
                                           torch.tensor(0.1, dtype=f64))
    m1, n1 = lands.m1, lands.n1
    row = m1 + n1
    assert float(l[row]) == pytest.approx(50.5)
    assert not np.isfinite(float(u[row]))
    np.testing.assert_allclose(A[row].numpy(), [-1.0, -1.5, -2.0, -2.5, 1.0])
    assert float(l[row + 1]) == -np.inf
    np.testing.assert_allclose(A[row + 1].numpy(), 0.0)
    assert A.shape[0] == master_rows(n1, m1, 1, cfg.max_cuts)
    mu = torch.arange(A.shape[0], dtype=f64)
    np.testing.assert_allclose(cut_dual_slice(mu, m1, n1, 1, 4)[0].numpy(),
                               [row, row + 1, row + 2, row + 3])
    assert jax.config.jax_enable_x64   # the JAX side of this file is f64
