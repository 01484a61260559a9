"""The port's master QP solver (sqlp_tpu_torch/ops/prox_qp.py) and its ADMM
check interval (ops/cuda/admm_kernel.py, plain version on the CPU) held
against the JAX package on the same numpy inputs, in float64."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import QPConfig as JQPConfig
from sqlp_tpu.ops.prox_qp import solve_qp as jax_solve_qp
from sqlp_tpu_torch.config import QPConfig
from sqlp_tpu_torch.ops.cuda.admm_kernel import admm_round, admm_round_ref
from sqlp_tpu_torch.ops.prox_qp import admm_operands, solve_qp

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _load(fname):
    d = np.load(os.path.join(DATA, fname))
    p = d["p_diag"] if "p_diag" in d.files else d["p"]
    return d, (p, d["g"], d["A"], d["l"], d["u"], d["is_eq"])


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("fname", ["compqp.npz", "compqp2.npz",
                                   "compqp3.npz"])
def test_captured_qps_match_jax(fname):
    """Captured lands compromise QPs: same z, mu and convergence flag as
    the JAX solve_qp. Tolerance 1e-6 (abs+rel): both runs take the same
    control-flow path in float64, but ADMM over thousands of steps and
    the polish solves amplify reassociation differences (1e-16 per op)
    toward the solve's own 1e-7 accuracy, so agreement is held at ten
    times tighter than what either run certifies."""
    _, args = _load(fname)
    jz, jmu, jst = jax_solve_qp(*map(jnp.asarray, args),
                                JQPConfig(tol=1e-7, max_iters=8_000))
    z, mu, st = solve_qp(*map(_t, args), QPConfig(tol=1e-7, max_iters=8_000))
    assert bool(st["qp_converged"]) == bool(jst["qp_converged"]) is True
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6,
                               atol=1e-6)


def test_warm_stall_master_matches_jax():
    """The lands master whose stale warm start traps ADMM: both packages
    detect the miss, rerun cold and reach the same optimum
    x = (0, 0, 12, 6.749...) (tolerance as above)."""
    d, args = _load("master_qp_warm_stall_lands.npz")
    jz, jmu, jst = jax_solve_qp(*map(jnp.asarray, args),
                                JQPConfig(tol=1e-9, max_iters=4_000),
                                z0=jnp.asarray(d["warm_z"]),
                                mu0=jnp.asarray(d["warm_mu"]))
    z, mu, st = solve_qp(*map(_t, args), QPConfig(tol=1e-9, max_iters=4_000),
                         z0=_t(d["warm_z"]), mu0=_t(d["warm_mu"]))
    assert bool(st["qp_converged"]) and bool(jst["qp_converged"])
    assert abs(float(z[:4].sum()) - 12.0) < 1e-6
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6,
                               atol=1e-6)
    assert int(st["qp_iters"]) == int(jst["qp_iters"])


def _jax_check_interval(As, M, Minv, g, lc, uc, rho, z, zeta, mu, n, alpha,
                        sigma):
    """The JAX package's one_step loop (sqlp_tpu/ops/prox_qp.py:198-206)
    with the explicit-inverse z-update, written out in jnp."""
    for _ in range(n):
        rhs = sigma * z - g + As.T @ (rho * zeta - mu)
        x = Minv @ rhs
        x = x + Minv @ (rhs - M @ x)
        v = alpha * (As @ x) + (1.0 - alpha) * zeta
        zeta1 = jnp.clip(v + mu / rho, lc, uc)
        mu = mu + rho * (v - zeta1)
        z, zeta = x, zeta1
    return z, zeta, mu


def test_admm_round_ref_matches_jax_one_step_loop():
    """One check interval (25 steps) of the plain version against the JAX
    loop on the scaled compqp operands, from a mid-solve point. Tolerance
    1e-12 relative: the same float64 operations in the same order up to
    the BLAS mat-vec reduction order."""
    _, args = _load("compqp.npz")
    cfg = QPConfig()
    ops = list(admm_operands(*map(_t, args), cfg, rho=cfg.rho))
    ops[7:] = admm_round_ref(*ops, 50, cfg.over_relax, cfg.sigma)
    out = admm_round(*ops, cfg.check_every, cfg.over_relax, cfg.sigma)
    ref = _jax_check_interval(*(jnp.asarray(o.numpy()) for o in ops),
                              cfg.check_every, cfg.over_relax, cfg.sigma)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-12,
                                   atol=1e-12 * (1 + np.abs(r).max()))


def test_admm_round_batched_cpu_matches_unbatched():
    """A leading batch axis (one QP per block on the card) gives each QP
    exactly its unbatched result on the CPU path."""
    _, args = _load("compqp2.npz")
    cfg = QPConfig()
    ops = admm_operands(*map(_t, args), cfg, rho=cfg.rho)
    one = admm_round(*ops, 25, cfg.over_relax, cfg.sigma)
    two = admm_round(*(torch.stack([o, o]) for o in ops), 25,
                     cfg.over_relax, cfg.sigma)
    for a, b in zip(one, two):
        assert torch.equal(b[0], a) and torch.equal(b[1], a)


def test_f32_inputs_solve_in_f64():
    """The master always runs in float64 (as the JAX package does with x64
    on); a float32 caller gets float32 results of the float64 solve."""
    _, args = _load("compqp.npz")
    z64, _, _ = solve_qp(*map(_t, args), QPConfig(tol=1e-7, max_iters=8_000))
    a32 = [_t(a).float() if np.asarray(a).dtype == np.float64 else _t(a)
           for a in args]
    z32, mu32, st = solve_qp(*a32, QPConfig(tol=1e-7, max_iters=8_000))
    assert z32.dtype == torch.float32 and st["qp_err"].dtype == torch.float32
    np.testing.assert_allclose(z32.numpy(), z64.numpy(), rtol=1e-4,
                               atol=1e-4)
