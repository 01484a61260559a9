"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc; every test skips without one. On a machine
with the card and no JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from sqlp_tpu_torch.config import QPConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.ops.cuda import admm_kernel, pdhg_kernel
from sqlp_tpu_torch.ops.pdhg import prepare_lp
from sqlp_tpu_torch.ops.prox_qp import admm_operands

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _round_args(name, B, dtype, dev, per_el_q):
    inst = load_instance(name, dtype=dtype, device=dev)
    a = inst.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    g = torch.Generator(device=dev).manual_seed(0)
    ht = torch.randn((B, lp.m), generator=g, dtype=dtype, device=dev)
    lb = torch.clamp(lp.lb, min=-1e30).contiguous()
    ub = torch.clamp(lp.ub, max=1e30).contiguous()
    q = (lp.q[None, :] * (1 + 0.1 * torch.rand(
        (B, lp.n), generator=g, dtype=dtype, device=dev))).contiguous() \
        if per_el_q else lp.q.contiguous()
    step = torch.full((B,), float(lp.step), dtype=dtype, device=dev)
    Y = torch.clamp(torch.randn((B, lp.n), generator=g, dtype=dtype,
                                device=dev), lb, ub).contiguous()
    L = torch.randn((B, lp.m), generator=g, dtype=dtype, device=dev)
    kh = torch.arange(B, dtype=dtype, device=dev)
    return (lp.K.contiguous(), q, lb, ub, lp.is_eq.contiguous(), ht, step,
            step.clone(), Y, L, kh, Y.clone(), L.clone())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("name,B,per_el_q", [("lands", 8, False),
                                             ("ssn", 3, True),
                                             ("ssn", 700, False)])
def test_pdhg_halpern_round_matches_plain(cuda, name, B, per_el_q, dtype,
                                          tol):
    """Kernel vs plain version over one 80-step round; relative tolerance
    1e-4 in f32, 1e-10 in f64 (reduction order differs). B = 700 takes
    the several-rows-per-block path with a ragged last block."""
    args = _round_args(name, B, dtype, cuda, per_el_q)
    before = pdhg_kernel.launches
    out = pdhg_kernel.pdhg_halpern_round(*args, 80)
    torch.cuda.synchronize()
    assert pdhg_kernel.launches == before + 1
    ref = pdhg_kernel.pdhg_halpern_round_ref(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("name,B,per_el_q", [("lands", 8, False),
                                             ("ssn", 3, True),
                                             ("ssn", 700, False)])
def test_pdhg_average_round_matches_plain(cuda, name, B, per_el_q, dtype,
                                          tol):
    """The restart-to-average kernel vs its plain version over one 80-step
    round (last iterate and running averages), at the tolerances of the
    Halpern round; it counts its own launches, not the Halpern kernel's."""
    args = _round_args(name, B, dtype, cuda, per_el_q)[:10]
    before = pdhg_kernel.average_launches
    halpern = pdhg_kernel.launches
    out = pdhg_kernel.pdhg_average_round(*args, 80)
    torch.cuda.synchronize()
    assert pdhg_kernel.average_launches == before + 1
    assert pdhg_kernel.launches == halpern
    ref = pdhg_kernel.pdhg_average_round_ref(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale


def test_solve_batch_average_scheme_runs_the_kernel(cuda):
    """solve_batch(scheme="average") on the card launches the average
    kernel and never the Halpern one, and its float64 objectives agree
    with the CPU run's plain version to 1e-6 relative (both solve to tol
    1e-9; only the reduction order differs)."""
    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.ops.pdhg import solve_batch
    inst = load_instance("transship", dtype=torch.float64)
    a = inst.arrays
    g = torch.Generator().manual_seed(2)
    H = a.r[None, :] + 0.1 * torch.rand((16, a.r.shape[0]), generator=g,
                                        dtype=torch.float64)
    cfg = PDHGConfig(scheme="average", tol=1e-9, max_iters=20_000)
    objs = []
    for dev in (torch.device("cpu"), cuda):
        lp = prepare_lp(*(t.to(dev) for t in (a.W, a.senses2, a.q, a.lb2,
                                             a.ub2)))
        before = (pdhg_kernel.launches, pdhg_kernel.average_launches)
        obj, _, _, _ = solve_batch(lp, H.to(dev), cfg)
        after = (pdhg_kernel.launches, pdhg_kernel.average_launches)
        assert after[0] == before[0]
        assert (after[1] > before[1]) == (dev.type == "cuda")
        objs.append(obj.cpu())
    torch.testing.assert_close(objs[1], objs[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_admm_round_matches_plain(cuda, dtype, tol):
    """Kernel vs plain version over one 25-step interval on a random
    well-conditioned QP, unbatched and with a batch of three."""
    g = torch.Generator().manual_seed(1)
    nz, mA = 40, 90
    A = torch.randn((mA, nz), generator=g, dtype=torch.float64)
    l = -torch.rand(mA, generator=g, dtype=torch.float64)
    u = torch.rand(mA, generator=g, dtype=torch.float64)
    l[:5], u[:5] = -np.inf, np.inf
    p = torch.rand(nz, generator=g, dtype=torch.float64)
    c = torch.randn(nz, generator=g, dtype=torch.float64)
    is_eq = torch.zeros(mA, dtype=torch.bool)
    cfg = QPConfig()
    ops = [o.to(cuda, dtype).contiguous()
           for o in admm_operands(p, c, A, l, u, is_eq, cfg)]
    out = admm_kernel.admm_round(*ops, 25, cfg.over_relax, cfg.sigma)
    ref = admm_kernel.admm_round_ref(*ops, 25, cfg.over_relax, cfg.sigma)
    for o, r in zip(out, ref):
        assert float((o - r).abs().max()) <= tol * (1 + float(r.abs().max()))
    batched = [torch.stack([o, o, o]) for o in ops]
    outb = admm_kernel.admm_round(*batched, 25, cfg.over_relax, cfg.sigma)
    for o, ob in zip(out, outb):
        assert torch.equal(ob[2], o)


def test_wrappers_refuse_bad_operands(cuda):
    """Wrong dtype, a CPU operand or a non-contiguous operand raises
    instead of launching or falling back."""
    args = list(_round_args("lands", 4, torch.float32, cuda, False))
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(TypeError):
        pdhg_kernel.pdhg_halpern_round(*bad, 4)
    bad = list(args)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        pdhg_kernel.pdhg_halpern_round(*bad, 4)
    bad = list(args)
    bad[8] = args[8].t().contiguous().t()
    with pytest.raises(ValueError):
        pdhg_kernel.pdhg_halpern_round(*bad, 4)
    bad = list(args[:10])
    bad[5] = args[5].double()
    with pytest.raises(TypeError):
        pdhg_kernel.pdhg_average_round(*bad, 4)
    bad[5] = args[5].cpu()
    with pytest.raises(ValueError):
        pdhg_kernel.pdhg_average_round(*bad, 4)
