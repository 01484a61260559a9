"""Restart rounds replayed from CUDA graphs (``ops/pdhg.py``:
``graphs_plan``, ``_RoundGraph``).

On the CPU: the rule that maps a round's plan to a graph or an eager
round, and a CPU solve, which replays and captures nothing and records
every round as eager. On the card (marked ``cuda``, skipped without
one): the graph path against the eager path (``_eager=True``) bit for bit
in every output, every ``stats`` entry and the launch counts, on a second
call of the same key too; a new capture after K changes in place; the
grid plan kept eager; and a profiler trace that sees every kernel a
graph replays. On a machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_round_graphs.py
"""

import collections
import gc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sqlp_tpu_torch.config import PDHGConfig, SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.scenario import sample_deltas
from sqlp_tpu_torch.ops.cuda import pdhg_kernel
from sqlp_tpu_torch.ops import pdhg
from sqlp_tpu_torch.ops.pdhg import graphs_plan, prepare_lp, solve_batch
from sqlp_tpu_torch.sd import driver
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs
from sqlp_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def recorder(monkeypatch):
    """An empty span store for the test."""
    monkeypatch.setattr(profiling, "_SPANS", [])
    monkeypatch.setattr(profiling, "_STACK", [])
    monkeypatch.setattr(profiling, "_WAS_OFF", True)
    return profiling.spans


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("plan,graphed", [
    (("cluster", 16, 1), True), (("tile", 4, "fma"), True),
    (("tile", 4, "fma", 12), True), (("tile", 8, "mma"), True),
    (("stream", 16, 16), True), (("small", 1, 1), True), (("rows", 2), True),
    (("grid", 128, 4), False), (None, False)])
def test_graphs_plan_by_plan_kind(plan, graphed):
    """Every plan that launches one kernel on the current stream replays
    from a graph; the grid plan (parts on streams of its own) and a CPU
    round (no plan) stay eager."""
    assert graphs_plan(plan) is graphed


@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_cpu_solve_replays_no_graph(recorder, scheme):
    """A CPU solve through two compaction rungs captures and replays
    nothing, counts no launch, records every round as eager and no
    capture, and gives the bits of ``_eager=True``."""
    inst = load_instance("lands", dtype=torch.float32, device="cpu")
    a = inst.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    gen = torch.Generator().manual_seed(2)
    H = a.r[None, :] * (1 + 0.5 * torch.rand((512, a.r.shape[0]),
                                             generator=gen))
    H[128:] = 0
    cfg = PDHGConfig(compact_min_batch=512, max_iters=800, scheme=scheme)
    graphs = dict(pdhg_kernel.graph_counts)
    launches = dict(pdhg_kernel.launches_by_shape)
    with profile(activities=[ProfilerActivity.CPU]):
        out = solve_batch(lp, H, cfg)
    assert dict(pdhg_kernel.graph_counts) == graphs
    assert dict(pdhg_kernel.launches_by_shape) == launches
    sp = recorder()
    rounds = [s for s in sp if s.name == "pdhg.round"]
    assert len(rounds) == out[3]["pdhg_rounds"] > 0
    assert len(out[3]["pdhg_phase_rounds"]) == 2
    assert all(r.attrs["graph"] is False for r in rounds)
    assert not [s for s in sp if s.name == "pdhg.capture"]
    _same(out, solve_batch(lp, H, cfg, _eager=True))


@pytest.mark.parametrize("scheme", ["halpern", "average"])
def test_graph_bookkeeping_on_the_cpu(monkeypatch, scheme):
    """The rung loop's graph path on CPU tensors, with a stand-in for the
    CUDA graph that runs the captured round again at each replay: the
    buffers carry the state from round to round and hand it to the
    scatter, so the results are the eager path's bits. A lands panel
    whose infeasible rows stall out on the 512-row rung: the first call
    captures each rung of more than one round after its first round and
    replays the rest, the second replays every round, and the LP's graphs
    go with it."""
    def capture(self, step, rec):
        self.graph = types.SimpleNamespace(replay=lambda: step(self, rec))
        pdhg_kernel.graph_counts["captures"] += 1
    monkeypatch.setattr(pdhg, "_round_plan", lambda lp, rows, s: ("rows", 1))
    monkeypatch.setattr(pdhg._RoundGraph, "capture", capture)
    monkeypatch.setattr(pdhg_kernel, "count_launch", lambda *a: None)
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    a, model = inst.arrays, inst.scenario_model
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    d = sample_deltas(torch.Generator().manual_seed(5), model, 2048)
    H = _scenario_rhs(a, model, d, torch.full((inst.n1,), 5.0,
                                              dtype=torch.float64))
    H[:300] = _scenario_rhs(a, model, d[:300],
                            torch.zeros(inst.n1, dtype=torch.float64))
    H[300:1200] = 0
    cfg = PDHGConfig(tol=1e-7, max_iters=20_000, scheme=scheme)
    for call in range(2):
        before = collections.Counter(pdhg_kernel.graph_counts)
        out = solve_batch(lp, H, cfg)
        done = collections.Counter(pdhg_kernel.graph_counts) - before
        _same(out, solve_batch(lp, H, cfg, _eager=True))
        per_rung = np.diff([0] + out[3]["pdhg_phase_rounds"])
        assert (per_rung > 1).sum() == 2
        if call == 0:
            assert done["captures"] == 2
            assert done["replays"] == sum(r - 1 for r in per_rung if r > 1)
        else:
            assert done == {"replays": out[3]["pdhg_rounds"]}
    key = id(lp)
    assert len(pdhg._GRAPHS[key][2]) == 2
    for g in pdhg._GRAPHS[key][2].values():
        g.graph = None      # the stand-in's round holds the LP; a graph not
    del lp
    gc.collect()
    assert key not in pdhg._GRAPHS


def _round(graph=None):
    s = profiling.Span("pdhg.round", {"rows": 4} if graph is None
                       else {"rows": 4, "graph": graph})
    s.start, s.end = 0, 1
    return s


@pytest.mark.parametrize("metric", ["pdhg.graph_round_share",
                                    "pdhg.graph_round_share.host_paced"])
@pytest.mark.parametrize("graphs,want", [
    ([True, True, True, False], 75.0), ([False, False], 0.0),
    ([True], 100.0), ([True, None], None), ([None, None], None), ([], None)])
def test_graph_round_share_reader(monkeypatch, metric, graphs, want):
    """The benchmark's reader: the share of the window's rounds that
    replayed, in %; nothing where a round carries no ``graph``
    attribute (a program that replays none), no round was recorded, or
    the run was not traced."""
    from sdbench.harness import load_metric
    from sdbench.trace import Trace
    read = load_metric(metric).read
    monkeypatch.setattr(profiling, "_SPANS", [_round(g) for g in graphs])
    obs = {"kind": "mc_ub", "trace": Trace(kernels=[], host_ops=[])}
    assert read(obs) == want
    assert read({"kind": "mc_ub"}) is None
    assert read(dict(obs, kind="ef")) is None


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).cpu()


def _same(a, b):
    """Two solve_batch results bit for bit: obj, Y, Pi and every stats
    entry."""
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(_bits(x), _bits(y))
    assert a[3].keys() == b[3].keys()
    for k, v in a[3].items():
        if torch.is_tensor(v):
            assert torch.equal(_bits(v), _bits(b[3][k])), k
        else:
            assert v == b[3][k], k


def _launched(run):
    """``run()`` and the launches it counted, by (counter, rows,
    itemsize)."""
    before = collections.Counter(pdhg_kernel.launches_by_shape)
    out = run()
    after = collections.Counter(pdhg_kernel.launches_by_shape)
    return out, after - before


# (instance, rows, dtype, first-stage x, max_iters): a 4096-row ssn panel
# through its 1024 and 256 rungs (tile), ssn's SD panel (cluster), a lands
# panel (small), and the ladder's f64 ssn re-solve bucket (f64 tile)
_CASES = {"ssn_4096": ("ssn", 4096, torch.float32, 0.0, 80_000),
          "ssn_sd": ("ssn", 2, torch.float32, 0.0, 80_000),
          "lands_8": ("lands", 8, torch.float32, 5.0, 8_000),
          "ssn_f64_256": ("ssn", 256, torch.float64, 0.0, 20_000)}


def _panel(name, B, dtype, x, dev, seed):
    """The solver's recourse LP of ``name`` (as the MC panels solve it)
    and a [B] panel of its right-hand sides at ``x``."""
    inst = load_instance(name, dtype=torch.float32, device=dev)
    solver = driver.SDSolver(inst, SDConfig(dtype="float32"),
                             x0=np.full(inst.n1, x), seed=0)
    lp = solver.prep_sub if dtype == torch.float32 else solver._prep_sub64
    gen = torch.Generator(device=dev).manual_seed(seed)
    H = _scenario_rhs(solver.arrays, inst.scenario_model,
                      sample_deltas(gen, inst.scenario_model, B),
                      torch.full((inst.n1,), x, device=dev))
    return lp, H.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CASES))
def test_graph_rounds_are_the_eager_rounds_bit_for_bit(cuda, case):
    """The graph path against the eager one: every output, every stats
    entry and the launches counted are equal; then a second call of the
    same keys with another panel and a warm start from the first."""
    name, B, dtype, x, max_iters = _CASES[case]
    lp, H = _panel(name, B, dtype, x, cuda, seed=1)
    cfg = PDHGConfig(tol=1e-4, max_iters=max_iters)
    eager, n_eager = _launched(lambda: solve_batch(lp, H, cfg, _eager=True))
    replays = pdhg_kernel.graph_counts["replays"]
    graph, n_graph = _launched(lambda: solve_batch(lp, H, cfg))
    assert pdhg_kernel.graph_counts["replays"] > replays
    _same(graph, eager)
    assert n_graph == n_eager
    if case == "ssn_4096":
        assert len(graph[3]["pdhg_phase_rounds"]) == 3

    _, H2 = _panel(name, B, dtype, x, cuda, seed=2)
    warm = dict(Y0=graph[1].flip(0), L0=graph[2].flip(0))
    eager, n_eager = _launched(
        lambda: solve_batch(lp, H2, cfg, _eager=True, **warm))
    graph, n_graph = _launched(lambda: solve_batch(lp, H2, cfg, **warm))
    _same(graph, eager)
    assert n_graph == n_eager


@pytest.mark.cuda
def test_changing_k_in_place_captures_anew(cuda):
    """A K changed in place (its version moves) is a new key: the next
    solve captures again, and still gives the eager bits."""
    lp, H = _panel("ssn", 2, torch.float32, 0.0, cuda, seed=3)
    cfg = PDHGConfig(tol=1e-4, max_iters=80_000)
    solve_batch(lp, H, cfg)
    captures = pdhg_kernel.graph_counts["captures"]
    solve_batch(lp, H, cfg)
    assert pdhg_kernel.graph_counts["captures"] == captures
    lp.K.mul_(1.0)
    graph = solve_batch(lp, H, cfg)
    assert pdhg_kernel.graph_counts["captures"] == captures + 1
    _same(graph, solve_batch(lp, H, cfg, _eager=True))


@pytest.mark.cuda
def test_grid_panels_stay_eager(cuda, recorder):
    """storm's float32 panels from 85 rows take the grid plan: every
    round is eager, nothing is captured or replayed."""
    lp, H = _panel("storm", 100, torch.float32, 0.0, cuda, seed=4)
    assert pdhg_kernel._plan(100, lp.m, lp.n, 4, "halpern")[0] == "grid"
    graphs = dict(pdhg_kernel.graph_counts)
    with profile(activities=[ProfilerActivity.CPU]):
        _, launched = _launched(lambda: solve_batch(
            lp, H, PDHGConfig(tol=1e-4, max_iters=800)))
    assert dict(pdhg_kernel.graph_counts) == graphs
    rounds = [s for s in recorder() if s.name == "pdhg.round"]
    assert rounds and all(r.attrs["graph"] is False for r in rounds)
    assert sum(n for (c, _, _), n in launched.items()
               if c == "grid_launches") == len(rounds)


@pytest.mark.cuda
def test_trace_sees_the_kernels_a_graph_replays(cuda):
    """Under the benchmark's profile (``sdbench.trace.traced``) the tile
    kernel's intervals are as many as the tile launches counted: the
    kernels of replayed rounds are in the trace, and a capture counts no
    launch."""
    from sdbench.trace import traced
    lp, H = _panel("ssn", 4096, torch.float32, 0.0, cuda, seed=5)
    cfg = PDHGConfig(tol=1e-4, max_iters=80_000)
    replays = pdhg_kernel.graph_counts["replays"]
    with traced(True) as tr:
        _, launched = _launched(lambda: solve_batch(lp, H, cfg))
        torch.cuda.synchronize()
    assert pdhg_kernel.graph_counts["replays"] > replays
    tiles = sum(1 for n, _, _ in tr.trace.kernels if "pdhg_tile_kernel" in n)
    assert tiles == sum(n for (c, _, _), n in launched.items()
                        if c == "tile_launches") > 0
