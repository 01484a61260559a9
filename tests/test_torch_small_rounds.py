"""The plain Halpern and restart-to-average rounds (ops/cuda/pdhg_kernel.py,
what CPU tensors run and what the small kernels are held to on the card)
against the JAX package's rounds at the shapes of the instances whose K
takes the small kernels, transship (35 x 77) and baa99-20 (40 x 250), in
float64. The JAX rounds are the loops of sqlp_tpu/ops/pdhg.py:305-320
(Halpern) and :330-340 (average), written out in jnp as the JAX package
runs them off the TPU; one round of its own solve_batch is held to the
port's at the same shapes too."""

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
from sqlp_tpu_torch.ops.cuda.pdhg_kernel import (pdhg_average_round,
                                                 pdhg_halpern_round)
from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch

torch.set_num_threads(1)

NAMES = ["transship", "baa99-20"]


def _jax_halpern_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, kh, Yanc,
                       Lanc, n):
    """The JAX package's Halpern inner loop (sqlp_tpu/ops/pdhg.py:305-320)
    in jnp; returns (Ycarry, Lcarry, Ycand, Lcand)."""
    qrow = q[None, :] if q.ndim == 1 else q
    tau, sig = tau[:, None], sig[:, None]

    def body(t, carry):
        Y, L, _, _ = carry
        G = qrow - L @ K
        Y1 = jnp.clip(Y - tau * G, lb, ub)
        Yb = 2.0 * Y1 - Y
        S = ht - Yb @ K.T
        Lr = L + sig * S
        L1 = jnp.where(is_eq[None, :], Lr, jnp.maximum(Lr, 0.0))
        k = (kh + t)[:, None].astype(Y.dtype)
        w = (k + 1.0) / (k + 2.0)
        return (w * Yb + (1.0 - w) * Yanc,
                w * (2.0 * L1 - L) + (1.0 - w) * Lanc, Y1, L1)

    return jax.lax.fori_loop(0, n, body, (Y, L, Y, L))


def _jax_average_round(K, q, lb, ub, is_eq, ht, tau, sig, Y, L, n):
    """The JAX package's restart-to-average inner loop
    (sqlp_tpu/ops/pdhg.py:330-340) in jnp; returns (Y, L, Yavg, Lavg)."""
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


def _operands(name, B, seed, per_el_q):
    """A round's float64 operands at the instance's prepared recourse LP:
    a right-hand side around r drawn by numpy, per-row step sizes, and
    iterates from 40 plain Halpern steps, so the round starts mid-solve."""
    inst = load_instance(name, dtype=torch.float64, device="cpu")
    a = inst.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    rng = np.random.default_rng(seed)
    r = a.r.numpy()
    H = r[None, :] * (1.0 + 0.2 * rng.random((B, lp.m))) \
        + 0.1 * rng.standard_normal((B, lp.m))
    ht = torch.as_tensor(H) * (lp.flip * lp.row_scale)[None, :]
    lb = torch.clamp(lp.lb, min=-1e30)
    ub = torch.clamp(lp.ub, max=1e30)
    q = lp.q
    if per_el_q:
        q = lp.q[None, :] * torch.as_tensor(1.0 + 0.2 * rng.random((B,
                                                                  lp.n)))
    tau = torch.as_tensor(float(lp.step) * rng.uniform(0.5, 2.0, B))
    sig = torch.as_tensor(float(lp.step) * rng.uniform(0.5, 2.0, B))
    Y = torch.clamp(torch.zeros((B, lp.n), dtype=torch.float64), lb, ub)
    L = torch.zeros((B, lp.m), dtype=torch.float64)
    kh = torch.zeros(B, dtype=torch.float64)
    args = [lp.K, q, lb, ub, lp.is_eq, ht, tau, sig]
    Y, L, Yc, Lc = pdhg_halpern_round(*args, Y, L, kh, Y, L, 40)
    return args, Y, L, Yc, Lc


def _close(a, b, tol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * (1.0 + np.abs(b).max()))


@pytest.mark.parametrize("per_el_q", [False, True],
                         ids=["shared_q", "per_el_q"])
@pytest.mark.parametrize("name", NAMES)
def test_halpern_round_ref_matches_jax_loop(name, per_el_q):
    """One 80-step Halpern round of the plain version against the JAX loop
    from a mid-solve point, anchors apart from the iterates. Tolerance
    1e-12 relative: the same float64 operations, only the BLAS reduction
    order differs."""
    args, Y, L, Yc, Lc = _operands(name, 6, 4, per_el_q)
    kh = torch.full((6,), 40.0, dtype=torch.float64)
    out = pdhg_halpern_round(*args, Y, L, kh, Yc, Lc, 80)
    ref = _jax_halpern_round(*(jnp.asarray(t.numpy()) for t in args
                               + [Y, L, kh, Yc, Lc]), 80)
    for o, r in zip(out, ref):
        _close(o.numpy(), r, 1e-12)


@pytest.mark.parametrize("per_el_q", [False, True],
                         ids=["shared_q", "per_el_q"])
@pytest.mark.parametrize("name", NAMES)
def test_average_round_ref_matches_jax_loop(name, per_el_q):
    """One 80-step restart-to-average round of the plain version against
    the JAX loop from a mid-solve point (last iterate and running
    averages). Tolerance 1e-12 relative."""
    args, Y, L, _, _ = _operands(name, 6, 5, per_el_q)
    out = pdhg_average_round(*args, Y, L, 80)
    ref = _jax_average_round(*(jnp.asarray(t.numpy()) for t in args
                               + [Y, L]), 80)
    for o, r in zip(out, ref):
        _close(o.numpy(), r, 1e-12)


@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_one_round_of_solve_batch_matches_jax_on_baa99(scheme):
    """solve_batch with max_iters == restart_every runs exactly one round
    of each package's round on baa99-20, so the returned Y / Pi are that
    round's candidate (Halpern) or average (unscaled). Tolerance 1e-10
    relative: 80 float64 steps whose only difference is the BLAS
    reduction order."""
    port = load_instance("baa99-20", dtype=torch.float64, device="cpu")
    ref = jax_load_instance("baa99-20", dtype=jnp.float64)
    a, ja = port.arrays, ref.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    jlp = jax_prepare_lp(ja.W, ja.senses2, ja.q, ja.lb2, ja.ub2)
    rng = np.random.default_rng(7)
    H = a.r.numpy()[None, :] * (1.0 + 0.2 * rng.random((8, port.m2)))
    cfg = dict(tol=1e-12, max_iters=80, restart_every=80, scheme=scheme)
    jobj, jY, jPi, jst = jax_solve_batch(jlp, jnp.asarray(H),
                                         JPDHGConfig(**cfg))
    obj, Y, Pi, st = solve_batch(lp, torch.as_tensor(H), PDHGConfig(**cfg))
    assert st["pdhg_rounds"] == int(jst["pdhg_rounds"]) == 1
    _close(Y.numpy(), jY, 1e-10)
    _close(Pi.numpy(), jPi, 1e-10)
    _close(obj.numpy(), jobj, 1e-10)
