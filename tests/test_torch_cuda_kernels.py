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


def _variant(name, B, dtype, variant, scheme="halpern"):
    """The plan the test forces: the wrapper's own, or its row-block,
    cluster or tile alternative at these shapes; ("tile", C) forces the
    cluster size."""
    inst = load_instance(name, dtype=dtype, device="cpu")
    m, n = inst.arrays.W.shape
    it = torch.finfo(dtype).bits // 8
    if isinstance(variant, tuple):
        return variant + (pdhg_kernel._TILE_ARITH[it],)
    if variant == "plan":
        return pdhg_kernel._plan(B, m, n, it, scheme)
    if variant == "rows":
        return ("rows", pdhg_kernel._rows_per_block(
            f"pdhg_{scheme}_round", B,
            pdhg_kernel._row_values(m, n, scheme) * it))
    if variant == "tile":
        return ("tile",) + pdhg_kernel._tile_shape(B, m, n, it, scheme)
    if variant == "stream":
        return ("stream",) + pdhg_kernel._stream_shape(B, m, n, it, scheme)
    if variant == "grid":
        return ("grid",) + pdhg_kernel._grid_shape(B, m, n, it)
    if variant == "small":
        return ("small",) + pdhg_kernel._small_shape(B, m, n, it)
    return ("cluster",) + pdhg_kernel._cluster_shape(B, m, n, it, scheme)


def _by_scheme():
    """(Halpern, average) launches of the row-block and small variants."""
    c = pdhg_kernel.launch_counts()
    return (c["launches"] + c["small_launches"],
            c["average_launches"] + c["average_small_launches"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("name,B,per_el_q,variant", [
    ("lands", 8, False, "plan"), ("lands", 8, False, "cluster"),
    ("ssn", 2, False, "plan"), ("ssn", 2, False, "rows"),
    ("ssn", 3, True, "plan"), ("ssn", 3, True, "rows"),
    ("ssn", 700, False, "plan"), ("ssn", 700, False, "cluster"),
    ("ssn", 700, False, "rows")])
def test_pdhg_halpern_round_matches_plain(cuda, name, B, per_el_q, variant,
                                          dtype, tol):
    """Each variant of the Halpern round vs the plain version over one
    80-step round; relative tolerance 1e-4 in f32, 1e-10 in f64 (reduction
    order differs). ssn B = 2 and B = 3 take the cluster kernel under the
    plan; B = 700 the tile kernel with a ragged last tile (forced: the
    row-block kernel with several rows per block and a ragged last block,
    the cluster kernel with a ragged last cluster). Each launch counts
    under its own variant."""
    plan = _variant(name, B, dtype, variant)
    if variant == "plan" and name == "ssn":
        assert plan[0] == ("tile" if B == 700 else "cluster")
    args = _round_args(name, B, dtype, cuda, per_el_q)
    before = pdhg_kernel.launch_counts()
    out = pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
    torch.cuda.synchronize()
    want = dict(before)
    want[pdhg_kernel.COUNTERS["halpern", plan[0]]] += 1
    assert pdhg_kernel.launch_counts() == want
    ref = pdhg_kernel.pdhg_halpern_round_ref(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("per_el_q", [False, True])
@pytest.mark.parametrize("name,B,variant", [
    ("ssn", 1, "tile"), ("ssn", 16, "tile"), ("ssn", 100, "tile"),
    ("ssn", 4096, "tile"), ("ssn", 100, ("tile", 16)),
    ("ssn", 100, ("tile", 8)), ("lands", 8, ("tile", 1)),
    ("lands", 40, ("tile", 4)), ("lands", 100, ("tile", 16)),
    ("ssn", 1, "cluster"), ("ssn", 16, "cluster"), ("ssn", 100, "cluster"),
    ("ssn", 256, "tile"), ("ssn", 512, "tile"), ("ssn", 768, "tile"),
    ("ssn", 1024, "tile"), ("ssn", 100, ("tile", 4)),
    ("lands", 40, ("tile", 8)), ("lands", 40, ("tile", 16)),
    ("ssn", 700, "tile"), ("ssn", 8192, "tile")])
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_pdhg_cluster_and_tile_kernels_match_plain(cuda, scheme, name, B,
                                                   variant, per_el_q, dtype,
                                                   tol):
    """The cluster-resident kernels of both schemes vs their plain versions
    over one 80-step round, shared and per-row q, within 1e-4 in f32: the
    tile kernel (FP32 FMAs in f32, FP64 matrix instructions in f64) at B =
    1, one full tile, a ragged last tile, the MC ladder's rungs and its
    4096 rows (several tiles per cluster), at the plan's cluster size and
    at every admitted one (4, 8 and 16; ssn's f64 slices fit from 8), on
    lands too (fewer columns and constraint rows than CTAs: some CTAs own
    nothing); the cluster kernel at B = 1, the replicated SD step's 16
    rows and a ragged last cluster. Two launches are bitwise equal, and
    each counts under its own variant."""
    args = _round_args(name, B, dtype, cuda, per_el_q)
    m, n = args[0].shape
    plan = _variant(name, B, dtype, variant, scheme)
    if plan[0] == "tile" and not pdhg_kernel._tile_fits(
            plan[1], m, n, args[0].element_size(), plan[2]):
        pytest.skip(f"{plan} does not fit {name} in {dtype}")
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    before = pdhg_kernel.launch_counts()
    out = kernel(*args, 80, plan=plan)
    again = kernel(*args, 80, plan=plan)
    torch.cuda.synchronize()
    want = dict(before)
    want[pdhg_kernel.COUNTERS[scheme, plan[0]]] += 2
    assert pdhg_kernel.launch_counts() == want
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale


@pytest.mark.parametrize("scheme", ["halpern", "average"])
@pytest.mark.parametrize("B,per_el_q", [(100, True), (256, False),
                                        (700, False)])
def test_short_float32_tiles_are_the_16_row_tiles_bit_for_bit(
        cuda, scheme, B, per_el_q):
    """A float32 row's sums do not depend on the rows beside it, so tiles
    of any height from 1 to 16 rows (the plan's own, a ragged last tile,
    one row) give the 16-row tiles' outputs bit for bit."""
    args = _round_args("ssn", B, torch.float32, cuda, per_el_q)
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    full = kernel(*args, 80, plan=("tile", 4, "fma", 16))
    for tm in (1, 3, 9, 12, 15, None):
        plan = ("tile", 4, "fma") + (() if tm is None else (tm,))
        out = kernel(*args, 80, plan=plan)
        torch.cuda.synchronize()
        assert all(torch.equal(a, o) for a, o in zip(full, out)), plan


@pytest.mark.parametrize("key", [
    "halpern ssn B=256 float32 q=shared C=4",
    "average ssn B=700 float32 q=shared C=4",
    "halpern ssn B=256 float64 q=shared C=8"])
def test_tile_kernel_reproduces_the_recorded_digests(cuda, key):
    """The tile kernel's outputs at chip_smoke.py's fixed inputs have the
    SHA-256 digests recorded there from the first tile design (chip_smoke.py's b1
    and b2 hold every recorded case)."""
    import chip_smoke
    case = next(c for c in chip_smoke._DIGEST_CASES
                if chip_smoke._digest_key(*c) == key)
    scheme, inst, B, dname, per_el, C = case
    args = chip_smoke._digest_inputs(inst, B, dname, per_el)
    args = args[:chip_smoke._PDHG_ARGS[scheme]]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    arith = pdhg_kernel._TILE_ARITH[args[0].element_size()]
    out = kernel(*args, 80, plan=("tile", C, arith))
    torch.cuda.synchronize()
    got = [chip_smoke._sha([o]) for o in out] + [chip_smoke._sha(args)]
    assert got == chip_smoke.TILE_DIGESTS[key]


def test_tile_kernel_keeps_nan(cuda):
    """A row that has diverged to NaN stays NaN through the tile kernel,
    and does not leak into the other rows of its tile."""
    args = list(_round_args("ssn", 16, torch.float32, cuda, False))
    args[8] = args[8].clone()
    args[8][3, 5] = float("nan")
    out = pdhg_kernel.pdhg_halpern_round(*args, 8,
                                         plan=("tile", 4, "fma"))
    ref = pdhg_kernel.pdhg_halpern_round_ref(*args, 8)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(torch.isnan(o), torch.isnan(r))
        assert bool(torch.isnan(o[3]).any())
        keep = [i for i in range(16) if i != 3]
        assert bool(torch.isfinite(o[keep]).all())


def test_forced_plans_that_do_not_fit_raise(cuda):
    """A plan= override the kernels cannot take raises; nothing falls
    back."""
    args = _round_args("ssn", 16, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="no tile kernel"):
        pdhg_kernel.pdhg_halpern_round(*args, 80, plan=("tile", 4, "mma"))
    with pytest.raises(ValueError, match="unknown plan"):
        pdhg_kernel.pdhg_average_round(*args[:10], 80, plan=("wgmma", 4))
    with pytest.raises(RuntimeError, match="failed to launch"):
        pdhg_kernel.pdhg_average_round(*args[:10], 80,
                                       plan=("cluster", 2, 8))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("per_el_q", [False, True])
@pytest.mark.parametrize("B,C", [(2, None), (16, None), (100, None),
                                 (256, None), (1024, None), (4096, None),
                                 (100, 3), (100, 4), (100, 5), (100, 8)])
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_stream_kernels_match_plain(cuda, scheme, B, C, per_el_q, dtype,
                                    tol):
    """The stream kernels of both schemes vs their plain versions over one
    80-step round at storm's shapes (the SD panel, 16 rows, a ragged
    tile, the MC ladder's rungs), at the plan's cluster size and at other
    sizes that fit (float32 only: float64 fits only 16), shared and per-row
    q: within 1e-4 in f32 and 1e-10 in f64; two launches bitwise equal,
    each counted under the stream variant; in float32 bit for bit the
    row-block kernel's round."""
    args = _round_args("storm", B, dtype, cuda, per_el_q)
    m, n = args[0].shape
    it = args[0].element_size()
    if C is None:
        C = pdhg_kernel._stream_shape(B, m, n, it, scheme)[0]
    if not pdhg_kernel._stream_fits(C, 16, m, n, it):
        pytest.skip(f"stream ({C}, 16) does not fit storm in {dtype}")
    plan = ("stream", C, 16)
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    before = pdhg_kernel.launch_counts()
    out = kernel(*args, 80, plan=plan)
    again = kernel(*args, 80, plan=plan)
    torch.cuda.synchronize()
    want = dict(before)
    want[pdhg_kernel.COUNTERS[scheme, plan[0]]] += 2
    assert pdhg_kernel.launch_counts() == want
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale
    if dtype == torch.float32:
        rows = kernel(*args, 80, plan=_variant("storm", B, dtype, "rows",
                                               scheme))
        assert all(torch.equal(a, o) for a, o in zip(rows, out))


def test_stream_kernel_keeps_nan(cuda):
    """A row that has diverged to NaN stays NaN through the stream kernel
    in both dtypes, and does not leak into the other rows of its tile."""
    for dtype in (torch.float32, torch.float64):
        args = list(_round_args("storm", 16, dtype, cuda, False))
        args[8] = args[8].clone()
        args[8][3, 5] = float("nan")
        out = pdhg_kernel.pdhg_halpern_round(*args, 8,
                                             plan=("stream", 16, 16))
        ref = pdhg_kernel.pdhg_halpern_round_ref(*args, 8)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert torch.equal(torch.isnan(o), torch.isnan(r))
            assert bool(torch.isnan(o[3]).any())
            keep = [i for i in range(16) if i != 3]
            assert bool(torch.isfinite(o[keep]).all())


def test_forced_stream_plans_that_do_not_fit_raise(cuda):
    """A stream plan the kernel cannot take at storm's shapes raises
    before any launch: 2 CTAs in f32 (no size of the kernel's: 630
    columns a CTA), any size but 16 in f64 (no room for two stages),
    tiles of 32 rows; the smem the wrapper counts is the kernel's own at
    every size."""
    from sqlp_tpu_torch.ops.cuda import build
    lib = build.load()
    m, n = 528, 1259
    for it in (4, 8):
        for C in pdhg_kernel._STREAM_SIZES:
            assert lib.pdhg_stream_smem(int(it == 8), C, m, n) \
                == pdhg_kernel._stream_smem(C, m, n, it)
    for dtype, plan in ((torch.float32, ("stream", 2, 16)),
                        (torch.float64, ("stream", 8, 16)),
                        (torch.float32, ("stream", 8, 32))):
        args = _round_args("storm", 16, dtype, cuda, False)
        before = pdhg_kernel.launch_counts()
        with pytest.raises(ValueError, match="no stream kernel"):
            pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
        assert pdhg_kernel.launch_counts() == before


@pytest.mark.parametrize("per_el_q", [False, True])
@pytest.mark.parametrize("B,shape", [(1024, None), (1000, None),
                                     (4096, None), (4096, (64, 3)),
                                     (300, (128, 2)), (600, (64, 1)),
                                     (2, (64, 1))])
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_grid_kernels_match_plain(cuda, scheme, B, shape, per_el_q):
    """The grid kernels of both schemes vs their plain versions over one
    80-step round at storm's float32 shapes (the MC panels of 1024 and
    4096 rows, ragged 1000, 600 and 300, the SD panel's 2 rows), at the
    plan's primal tile height and part count and at others (a ragged last
    part, one part), shared and per-row q: within 1e-4; two launches
    bitwise equal, each counted under the grid variant; bit for bit the
    row-block kernel's round."""
    args = _round_args("storm", B, torch.float32, cuda, per_el_q)
    m, n = args[0].shape
    if shape is None:
        shape = pdhg_kernel._grid_shape(B, m, n, 4)
    plan = ("grid",) + tuple(shape)
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    before = pdhg_kernel.launch_counts()
    out = kernel(*args, 80, plan=plan)
    again = kernel(*args, 80, plan=plan)
    torch.cuda.synchronize()
    want = dict(before)
    want[pdhg_kernel.COUNTERS[scheme, plan[0]]] += 2
    assert pdhg_kernel.launch_counts() == want
    assert all(torch.equal(a, o) for a, o in zip(again, out))
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= 1e-4 * scale
    rows = kernel(*args, 80, plan=_variant("storm", B, torch.float32, "rows",
                                           scheme))
    assert all(torch.equal(a, o) for a, o in zip(rows, out))


def test_grid_kernel_keeps_nan(cuda):
    """A row that has diverged to NaN stays NaN through the grid kernels
    of both schemes, as through the row-block kernel, and does not leak
    into the other rows of its tiles."""
    for scheme in ("halpern", "average"):
        args = list(_round_args("storm", 300, torch.float32, cuda, False))
        args[8] = args[8].clone()
        args[8][3, 5] = float("nan")
        if scheme == "average":
            args = args[:10]
        kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
        out = kernel(*args, 8, plan=("grid", 64, 2))
        rows = kernel(*args, 8, plan=("rows", 1))
        torch.cuda.synchronize()
        for o, r in zip(out, rows):
            assert torch.equal(torch.isnan(o), torch.isnan(r))
            assert bool(torch.isnan(o[3]).any())
            keep = [i for i in range(300) if i != 3]
            assert bool(torch.isfinite(o[keep]).all())
            assert torch.equal(o[keep], r[keep])


def test_forced_grid_plans_that_do_not_fit_raise(cuda):
    """A grid plan the kernel cannot take raises before any launch: a
    float64 panel, a primal tile height it does not have, 5 parts; the
    smem the wrapper counts is the kernel's own at every height."""
    from sqlp_tpu_torch.ops.cuda import build
    lib = build.load()
    for BM in (32, 64, 96, 128):
        assert lib.pdhg_grid_smem(BM) == pdhg_kernel._grid_smem(BM, 4)
    for dtype, plan in ((torch.float64, ("grid", 128, 4)),
                        (torch.float32, ("grid", 96, 1)),
                        (torch.float32, ("grid", 32, 1)),
                        (torch.float32, ("grid", 64, 5))):
        args = _round_args("storm", 1024, dtype, cuda, False)
        before = pdhg_kernel.launch_counts()
        with pytest.raises(ValueError, match="no grid kernel"):
            pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
        with pytest.raises(ValueError, match="no grid kernel"):
            pdhg_kernel.pdhg_average_round(*args[:10], 80, plan=plan)
        assert pdhg_kernel.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_kernels_are_deterministic(cuda, dtype):
    """Two launches of the cluster Halpern round (ssn, B = 2), of the tile
    round of both schemes at every cluster size that fits ssn (B = 700,
    several tiles per cluster at the larger sizes) and of the cluster B3
    (a storm-shaped master, eight CTAs) give bitwise-equal outputs: every
    cross-CTA sum runs in a fixed rank order."""
    args = _round_args("ssn", 2, dtype, cuda, False)
    plan = _variant("ssn", 2, dtype, "plan")
    assert plan[0] == "cluster"
    a = pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
    b = pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    args = _round_args("ssn", 700, dtype, cuda, False)
    m, n = args[0].shape
    it = args[0].element_size()
    sizes = [C for C in pdhg_kernel._CLUSTER_SIZES
             if pdhg_kernel._tile_fits(C, m, n, it,
                                       pdhg_kernel._TILE_ARITH[it])]
    assert sizes == ([4, 8, 16] if it == 4 else [8, 16])
    for scheme, n_args in (("halpern", 13), ("average", 10)):
        kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
        for C in sizes:
            plan = ("tile", C, pdhg_kernel._TILE_ARITH[it])
            a = kernel(*args[:n_args], 80, plan=plan)
            b = kernel(*args[:n_args], 80, plan=plan)
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    ops, cfg = _master_ops(403, 122, cuda, dtype)
    a = admm_kernel.admm_round(*ops, 25, cfg.over_relax, cfg.sigma)
    b = admm_kernel.admm_round(*ops, 25, cfg.over_relax, cfg.sigma)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("name,B,per_el_q", [("lands", 8, False),
                                             ("ssn", 3, True),
                                             ("ssn", 700, False)])
def test_pdhg_average_round_matches_plain(cuda, name, B, per_el_q, dtype,
                                          tol):
    """The restart-to-average round's row-block kernel vs its plain version
    over one 80-step round (last iterate and running averages), at the
    tolerances of the Halpern round; it counts its own launches, not the
    Halpern kernel's."""
    args = _round_args(name, B, dtype, cuda, per_el_q)[:10]
    before = pdhg_kernel.launch_counts()
    out = pdhg_kernel.pdhg_average_round(
        *args, 80, plan=_variant(name, B, dtype, "rows", "average"))
    torch.cuda.synchronize()
    after = pdhg_kernel.launch_counts()
    assert after["average_launches"] == before["average_launches"] + 1
    assert after["launches"] == before["launches"]
    ref = pdhg_kernel.pdhg_average_round_ref(*args, 80)
    for o, r in zip(out, ref):
        scale = 1.0 + float(r.abs().max())
        assert float((o - r).abs().max()) <= tol * scale


def test_solve_batch_average_scheme_runs_the_kernel(cuda):
    """solve_batch(scheme="average") on the card launches the average
    kernel (transship's K takes its small variant) and never a Halpern
    one, and its float64 objectives agree with the CPU run's plain
    version to 1e-6 relative (both solve to tol 1e-9; only the reduction
    order differs)."""
    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.ops.pdhg import solve_batch
    inst = load_instance("transship", dtype=torch.float64, device="cpu")
    a = inst.arrays
    g = torch.Generator().manual_seed(2)
    H = a.r[None, :] + 0.1 * torch.rand((16, a.r.shape[0]), generator=g,
                                        dtype=torch.float64)
    cfg = PDHGConfig(scheme="average", tol=1e-9, max_iters=20_000)
    objs = []
    for dev in (torch.device("cpu"), cuda):
        lp = prepare_lp(*(t.to(dev) for t in (a.W, a.senses2, a.q, a.lb2,
                                             a.ub2)))
        before = _by_scheme()
        obj, _, _, _ = solve_batch(lp, H.to(dev), cfg)
        after = _by_scheme()
        assert after[0] == before[0]
        assert (after[1] > before[1]) == (dev.type == "cuda")
        objs.append(obj.cpu())
    torch.testing.assert_close(objs[1], objs[0], rtol=1e-6, atol=1e-6)


_SMALL_INSTANCES = ("lands", "transship", "baa99-20")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("per_el_q", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 16, 1000, 4096])
@pytest.mark.parametrize("name", _SMALL_INSTANCES)
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_small_kernels_are_the_row_block_round_bit_for_bit(
        cuda, scheme, name, B, per_el_q, dtype, tol):
    """The small kernels of both schemes against the row-block kernels
    over one 80-step round, bit for bit in both dtypes (the same sums in
    the same order, the epilogues' roundings pinned), at the plan's group
    shape and at every group width and rows a group that fit (a ragged
    last group at B = 3 and 1000); within tolerance of the plain version;
    two launches bitwise equal; each launch counted under the small
    variant."""
    args = _round_args(name, B, dtype, cuda, per_el_q)
    if scheme == "average":
        args = args[:10]
    m, n = args[0].shape
    it = args[0].element_size()
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    rows = kernel(*args, 80, plan=_variant(name, B, dtype, "rows", scheme))
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 80)
    own = _variant(name, B, dtype, "small", scheme)
    plans = [own] + [("small", W, R) for W in (1, 2, 4, 8)
                     for R in pdhg_kernel._SMALL_ROWS
                     if ("small", W, R) != own and R <= B
                     and pdhg_kernel._small_fits(W, R, 1, m, n, it)]
    for plan in plans:
        before = pdhg_kernel.launch_counts()
        out = kernel(*args, 80, plan=plan)
        again = kernel(*args, 80, plan=plan)
        torch.cuda.synchronize()
        want = dict(before)
        want[pdhg_kernel.COUNTERS[scheme, plan[0]]] += 2
        assert pdhg_kernel.launch_counts() == want
        assert all(torch.equal(a, o) for a, o in zip(again, out)), plan
        assert all(torch.equal(a, o) for a, o in zip(rows, out)), plan
        for o, r in zip(out, ref):
            scale = 1.0 + float(r.abs().max())
            assert float((o - r).abs().max()) <= tol * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_small_kernel_keeps_nan(cuda, scheme, dtype):
    """A row that has diverged to NaN stays NaN through the small kernel,
    as through the row-block kernel, and does not leak into the other rows
    of its group."""
    args = list(_round_args("baa99-20", 16, dtype, cuda, False))
    args[8] = args[8].clone()
    args[8][3, 5] = float("nan")
    if scheme == "average":
        args = args[:10]
    kernel = getattr(pdhg_kernel, f"pdhg_{scheme}_round")
    ref = getattr(pdhg_kernel, f"pdhg_{scheme}_round_ref")(*args, 8)
    rows = kernel(*args, 8, plan=("rows", 1))
    for plan in (("small", 4, 4), ("small", 1, 2)):
        out = kernel(*args, 8, plan=plan)
        torch.cuda.synchronize()
        for o, r, b in zip(out, ref, rows):
            assert torch.equal(torch.isnan(o), torch.isnan(r))
            assert torch.equal(torch.isnan(o), torch.isnan(b))
            assert bool(torch.isnan(o[3]).any())
            keep = [i for i in range(16) if i != 3]
            assert bool(torch.isfinite(o[keep]).all())


def test_forced_small_plans_that_do_not_fit_raise(cuda):
    """A forced small plan whose group width or rows the kernel does not
    have, or whose one group misses a block's shared memory (ssn's K),
    raises at the wrapper before anything launches; nothing falls back."""
    args = _round_args("lands", 16, torch.float32, cuda, False)
    before = pdhg_kernel.launch_counts()
    for plan in (("small", 3, 1), ("small", 1, 8), ("small", 32, 1),
                 ("small", 1.0, 1)):
        with pytest.raises(ValueError, match="no small kernel"):
            pdhg_kernel.pdhg_halpern_round(*args, 80, plan=plan)
        with pytest.raises(ValueError, match="no small kernel"):
            pdhg_kernel.pdhg_average_round(*args[:10], 80, plan=plan)
    with pytest.raises(ValueError, match="unknown plan"):
        pdhg_kernel.pdhg_halpern_round(*args, 80, plan=("small", 1))
    big = _round_args("ssn", 4, torch.float32, cuda, False)
    with pytest.raises(ValueError, match="no small kernel"):
        pdhg_kernel.pdhg_halpern_round(*big, 80, plan=("small", 8, 1))
    assert pdhg_kernel.launch_counts() == before


@pytest.mark.parametrize("q_rows", [0, 1])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", _SMALL_INSTANCES)
def test_small_smem_mirrors_the_kernel(cuda, name, itemsize, q_rows):
    """pdhg_kernel._small_smem is the kernel's own footprint
    (pdhg_small.cuh:smem_bytes) at every (R, G) a block may hold."""
    from sqlp_tpu_torch.ops.cuda import build
    inst = load_instance(name, dtype=torch.float64, device="cpu")
    m, n = inst.arrays.W.shape
    lib = build.load()
    for R in pdhg_kernel._SMALL_ROWS:
        for G in (1, 2, 4, 8, 16):
            assert lib.pdhg_small_smem(R, G, m, n, itemsize, q_rows) == \
                pdhg_kernel._small_smem(R, G, m, n, itemsize, q_rows)


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


def _master_ops(mA, nz, dev, dtype, seed=3):
    """Operands of a random well-conditioned master QP at a real master's
    shape (ssn 187 x 90, storm 403 x 122)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((mA, nz), generator=g, dtype=torch.float64)
    l = -torch.rand(mA, generator=g, dtype=torch.float64)
    u = torch.rand(mA, generator=g, dtype=torch.float64)
    l[:7], u[:7] = -np.inf, np.inf
    p = torch.rand(nz, generator=g, dtype=torch.float64)
    c = torch.randn(nz, generator=g, dtype=torch.float64)
    is_eq = torch.zeros(mA, dtype=torch.bool)
    cfg = QPConfig()
    ops = [o.to(dev, dtype).contiguous()
           for o in admm_operands(p, c, A, l, u, is_eq, cfg)]
    return ops, cfg


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
@pytest.mark.parametrize("mA,nz", [(187, 90), (403, 122)])
def test_admm_cluster_matches_plain(cuda, mA, nz, dtype, tol):
    """The cluster B3 at the ssn and storm master shapes vs the plain
    version over one 25-step interval, unbatched and with a leading batch
    of 8 distinct masters (one cluster each), for every cluster size whose
    slices fit; the plan takes the largest, 8."""
    ops, cfg = _master_ops(mA, nz, cuda, dtype)
    it = ops[0].element_size()
    sizes = [C for C in (1, 2, 4, 8)
             if admm_kernel._smem_bytes(C, mA, nz, it)
             <= admm_kernel._SMEM_MAX]
    assert admm_kernel._plan(mA, nz, it) == sizes[-1] == 8
    ref = admm_kernel.admm_round_ref(*ops, 25, cfg.over_relax, cfg.sigma)
    scale = 1.0 + 0.1 * torch.arange(8, dtype=dtype, device=cuda)
    batched = [torch.stack([o] * 8) for o in ops]
    batched[3] = batched[3] * scale[:, None]      # g differs per master
    refb = [admm_kernel.admm_round_ref(*(t[b] for t in batched), 25,
                                       cfg.over_relax, cfg.sigma)
            for b in range(8)]
    for C in sizes:
        before = admm_kernel.launches
        out = admm_kernel.admm_round(*ops, 25, cfg.over_relax, cfg.sigma,
                                     plan=C)
        outb = admm_kernel.admm_round(*batched, 25, cfg.over_relax,
                                      cfg.sigma, plan=C)
        torch.cuda.synchronize()
        assert admm_kernel.launches == before + 2
        for o, r in zip(out, ref):
            assert float((o - r).abs().max()) <= tol * (
                1 + float(r.abs().max()))
        for b in range(8):
            for o, r in zip(outb, refb[b]):
                assert float((o[b] - r).abs().max()) <= tol * (
                    1 + float(r.abs().max()))


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
