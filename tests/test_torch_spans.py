"""The port's spans (``sqlp_tpu_torch/utils/profiling.py``) on the
recourse path and the certification EF, and the benchmark's readers of
them (``sdbench/spans.py``, ``sdbench/metrics/``): nothing is recorded
outside a profiler; under one, a panel through the driver's ladder gives
the tree driver.panel > ladder.* > pdhg.solve > pdhg.round with one round
span per round the solver counted, rung by rung, each round's host read
inside its [enqueued, end]; the EF gives one round span per round; the
readers give their known answers on a synthetic trace."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdbench import spans as bench_spans
from sdbench.harness import load_metric
from sdbench.trace import Trace
from sqlp_tpu_torch.config import PDHGConfig, SDConfig
from sqlp_tpu_torch.models.crash import solve_extensive_form
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.models.scenario import sample_deltas
from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch
from sqlp_tpu_torch.sd import driver
from sqlp_tpu_torch.sd.algorithm import _scenario_rhs
from sqlp_tpu_torch.utils import profiling

torch.set_num_threads(2)

LADDER = ["ladder.first", "ladder.resolve", "ladder.f64", "ladder.host"]


@pytest.fixture
def recorder(monkeypatch):
    """An empty span store for the test."""
    monkeypatch.setattr(profiling, "_SPANS", [])
    monkeypatch.setattr(profiling, "_STACK", [])
    monkeypatch.setattr(profiling, "_WAS_OFF", True)
    return profiling.spans


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _host_reads(prof):
    """Start and end (ns) of every ``aten::_local_scalar_dense``, the host
    read under ``int(tensor)``."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == "aten::_local_scalar_dense")


def _check_rounds(rounds, reads, n_rounds):
    """Each round's stamps in order; every round that ended on a host read
    (all but one that reached ``n_rounds``) holds it in [enqueued, end];
    the rounds of a solve tile its loop."""
    for r in rounds:
        assert r.start <= r.attrs["launched"] <= r.attrs["enqueued"] <= r.end
    for i, r in enumerate(rounds):
        if i + 1 == n_rounds:
            continue
        assert any(r.attrs["enqueued"] <= a and b <= r.end
                   for a, b in reads), i
    for a, b in zip(rounds, rounds[1:]):
        assert a.end <= b.start


def _lands_lp():
    inst = load_instance("lands", dtype=torch.float32, device="cpu")
    a = inst.arrays
    return inst, prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)


def test_no_span_outside_a_profiler(recorder):
    """Outside a profiler a span is the shared no-op and a solve records
    nothing."""
    inst, lp = _lands_lp()
    H = inst.arrays.r[None, :].repeat(4, 1)
    assert profiling.span("x", rows=1) is profiling._OFF
    assert not profiling.span("x")
    solve_batch(lp, H, PDHGConfig(max_iters=160))
    assert recorder() == []


def test_a_new_session_empties_the_store(recorder):
    """A session's spans stay until the first span of the next session
    (one asked for outside a session came between): the store holds one
    session's."""
    with _cpu_profile():
        with profiling.span("a", rows=1):
            with profiling.span("b"):
                pass
    assert [(s.name, s.parent) for s in recorder()] == [("a", -1),
                                                         ("b", 0)]
    assert not profiling.span("between")
    assert [s.name for s in recorder()] == ["a", "b"]
    with _cpu_profile():
        with profiling.span("c"):
            pass
    assert [(s.name, s.parent) for s in recorder()] == [("c", -1)]


def test_recourse_ladder_span_tree(recorder, monkeypatch):
    """An 8-row ssn panel through ``_recourse_objs`` with 2 rounds a solve
    walks every step of the ladder: the tree, the attributes, one round
    span per counted round, and each round's host read inside it."""
    inst = load_instance("ssn", dtype=torch.float32, device="cpu")
    solver = driver.SDSolver(
        inst, SDConfig(pdhg=PDHGConfig(max_iters=160), dtype="float32"),
        x0=np.zeros(inst.n1), seed=0)
    gen = torch.Generator().manual_seed(1)
    deltas = sample_deltas(gen, inst.scenario_model, 8)
    H = _scenario_rhs(solver.arrays, inst.scenario_model, deltas,
                      torch.zeros(inst.n1))
    stats = []
    real = driver.solve_batch

    def counted(*a, **k):
        out = real(*a, **k)
        stats.append(out[3])
        return out
    monkeypatch.setattr(driver, "solve_batch", counted)
    with _cpu_profile() as prof, pytest.warns(UserWarning):
        solver._recourse_objs(H)
    sp = recorder()
    reads = _host_reads(prof)

    def kids(i):
        return [j for j, s in enumerate(sp) if s.parent == i]
    top = [i for i, s in enumerate(sp) if s.parent == -1]
    assert [sp[i].name for i in top] == ["driver.panel"]
    panel = sp[top[0]]
    steps = kids(top[0])
    assert [sp[i].name for i in steps] == LADDER
    assert panel.attrs == {"rows": 8, "first": 0, "resolve": 0, "f64": 0,
                           "host": 8}
    for i, bucket in zip(steps, (8, 256, 256, 0)):
        assert sp[i].attrs == {"rows": 8, "bucket": bucket,
                               "certified": 8 if bucket == 0 else 0}
    solves = [kids(i) for i in steps]
    assert [len(s) for s in solves] == [1, 1, 1, 0]
    for (j,), st, B, itemsize in zip(solves, stats, (8, 256, 256),
                                     (4, 4, 8)):
        assert sp[j].name == "pdhg.solve"
        assert sp[j].attrs == {"B": B, "itemsize": itemsize,
                               "rounds": st["pdhg_rounds"]}
        rounds = [sp[k] for k in kids(j)]
        assert {r.name for r in rounds} == {"pdhg.round"}
        assert len(rounds) == st["pdhg_rounds"] == 2
        assert st["pdhg_phase_rounds"] == [len(rounds)]
        assert {r.attrs["rows"] for r in rounds} == {B}
        _check_rounds(rounds, reads, 2)
    assert len(bench_spans.named(sp, "pdhg.round")) == \
        sum(st["pdhg_rounds"] for st in stats)


def test_compaction_rungs_spans(recorder):
    """A 512-row lands panel whose 384 zero rows finish in the first round
    runs on the 256-row rung after it: the compaction's gather and scatter
    spans, and the rounds per rung as ``pdhg_phase_rounds`` counts them."""
    inst, lp = _lands_lp()
    gen = torch.Generator().manual_seed(2)
    r = inst.arrays.r
    H = r[None, :] * (1 + 0.5 * torch.rand((512, r.shape[0]), generator=gen))
    H[128:] = 0
    with _cpu_profile() as prof:
        _, _, _, st = solve_batch(lp, H, PDHGConfig(compact_min_batch=512,
                                                    max_iters=800))
    sp = recorder()
    assert [s.name for s in sp if s.name != "pdhg.round"] == \
        ["pdhg.solve", "pdhg.compact", "pdhg.compact"]
    assert all(s.parent == 0 for s in sp[1:])
    assert [s.attrs["rows"] for s in bench_spans.named(sp, "pdhg.compact")] \
        == [256, 256]
    rounds = bench_spans.named(sp, "pdhg.round")
    phase = st["pdhg_phase_rounds"]
    assert len(phase) == 2 and 0 < phase[0] < phase[1]
    assert [r.attrs["rows"] for r in rounds] == \
        [512] * phase[0] + [256] * (phase[1] - phase[0])
    _check_rounds(rounds[:phase[0]], _host_reads(prof), -1)
    _check_rounds(rounds[phase[0]:], _host_reads(prof),
                  phase[1] - phase[0])


def test_ef_round_spans(recorder):
    """Two lands EFs of 4 scenarios for 5 rounds: one ef.round span per
    round run, under one ef.solve."""
    inst = load_instance("lands", dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    deltas = torch.stack([sample_deltas(gen, inst.scenario_model, 4)
                          for _ in range(2)])
    probs = torch.full((4,), 0.25)
    with _cpu_profile():
        _, _, st = solve_extensive_form(
            inst.arrays, inst.scenario_model, deltas, probs,
            PDHGConfig(tol=1e-12, max_iters=400, restart_every=80))
    sp = recorder()
    assert sp[0].name == "ef.solve" and sp[0].attrs == {"R": 2, "S": 4}
    rounds = sp[1:]
    assert {(r.name, r.parent) for r in rounds} == {("ef.round", 0)}
    assert len(rounds) == int(st["ef_iters"].max()) // 80 == 5
    for a, b in zip(rounds, rounds[1:]):
        assert a.start <= a.attrs["enqueued"] <= a.end <= b.start


def _span(name, start, end, parent, **attrs):
    s = profiling.Span(name, attrs)
    s.start, s.end, s.parent = start, end, parent
    return s


# a synthetic traced window, spans in ns, kernels in us: round 1 [2, 30]
# us is covered by kernels over [5, 30] (two overlapping, one straddling
# into round 2), round 2 [30, 58] over [30, 40] and [50, 58]
_SPANS = [
    _span("driver.panel", 0, 100_000, -1),
    _span("ladder.first", 1_000, 60_000, 0),
    _span("pdhg.solve", 2_000, 59_000, 1),
    _span("pdhg.round", 2_000, 30_000, 2, rows=4, launched=4_000,
          enqueued=10_000),
    _span("pdhg.round", 30_000, 58_000, 2, rows=4, launched=31_000,
          enqueued=36_000),
    _span("ladder.resolve", 60_000, 80_000, 0),
    _span("ladder.host", 80_000, 90_000, 0),
]
_KERNELS = [("k1", 5.0, 25.0), ("k2", 20.0, 28.0), ("k3", 27.0, 40.0),
            ("k4", 50.0, 70.0)]
_EF_SPANS = [
    _span("ef.solve", 0, 9_000_000, -1),
    _span("ef.round", 0, 5_000_000, 0, enqueued=2_000_000),
    _span("ef.round", 5_000_000, 9_000_000, 0, enqueued=9_000_000),
]


@pytest.mark.parametrize("metric,kind,want", [
    ("pdhg.host_us_per_round", "mc_ub", (8.0 + 6.0) / 2),
    ("pdhg.host_us_per_round.host_paced", "mc_ub", 7.0),
    ("pdhg.idle_us_per_round", "mc_ub", (3.0 + 10.0) / 2),
    ("pdhg.idle_us_per_round.host_paced", "mc_ub", 6.5),
    ("driver.escalation_share", "mc_ub", 100.0 * (20 + 10) / 100),
    ("driver.escalation_share.host_paced", "mc_ub", 30.0),
    ("ef.host_ms_per_round", "ef", (2.0 + 4.0) / 2)])
def test_readers_known_answers(monkeypatch, metric, kind, want):
    """Each reader on the synthetic window; None without a trace, in
    another kind of cell, or with no spans recorded."""
    read = load_metric(metric).read
    trace = Trace(kernels=_KERNELS, host_ops=[])
    obs = {"kind": kind, "trace": trace}
    monkeypatch.setattr(profiling, "_SPANS",
                        _EF_SPANS if kind == "ef" else _SPANS)
    assert read(obs) == pytest.approx(want)
    assert read({"kind": kind}) is None
    assert read({"kind": "other", "trace": trace}) is None
    monkeypatch.setattr(profiling, "_SPANS", [])
    assert read(obs) is None


# ten launches of 1 us inside a round stamped [0, 50] us to `enqueued`
_LAUNCHES = [("cudaLaunchKernel", 2.0 + 4 * k, 3.0 + 4 * k)
             for k in range(10)]


@pytest.mark.parametrize("metric,name,kind,scale", [
    ("pdhg.host_us_per_round", "pdhg.round", "mc_ub", 1.0),
    ("ef.host_ms_per_round", "ef.round", "ef", 1e-3)])
@pytest.mark.parametrize("extra,want", [
    ([], 50.0),                                        # no call waited
    ([("cudaLaunchKernel", 43.0, 48.0)], 46.0),        # a launch waited 4
    ([("cudaLaunchKernel", 43.0, 44.8)], 50.0),        # a slow one did not
    ([("cudaStreamSynchronize", 43.0, 48.0)], 45.0),   # a sync, all of it
    ([("cudaLaunchKernel", 60.0, 90.0)], 50.0),        # past `enqueued`
    ([("Activity Buffer Request", 43.0, 48.0)], 50.0)])  # the profiler's
def test_host_time_leaves_out_waits(monkeypatch, metric, name, kind, scale,
                                    extra, want):
    """The host readers take from a round's stamped time the part past
    its name's median of a CUDA call over twice that median, and all of
    a synchronizing call: a round whose launch waited on a full queue
    reads less than one whose launches did not."""
    rnd = _span(name, 0, 100_000, -1, launched=1_000, enqueued=50_000)
    monkeypatch.setattr(profiling, "_SPANS", [rnd])
    trace = Trace(kernels=[("k", 10.0, 95.0)], host_ops=_LAUNCHES + extra)
    got = load_metric(metric).read({"kind": kind, "trace": trace})
    assert got == pytest.approx(want * scale)


def test_idle_by_span_and_read_held(monkeypatch):
    """The synthetic window's 65 us of idle time by the innermost span
    over it, a round split at its stamps; and the share of rounds whose
    [enqueued, end] holds a host event whole."""
    trace = Trace(kernels=_KERNELS, host_ops=[
        ("cudaMemcpyAsync", 12.0, 29.0), ("cudaMemcpyAsync", 50.0, 60.0)])
    got = bench_spans.idle_by_span(trace, _SPANS, 120e-6)
    want = {"driver.panel": 11.0, "ladder.first": 1.0, "pdhg.solve": 0.0,
            "pdhg.round: to launched": 2.0,
            "pdhg.round: launched to enqueued": 1.0,
            "pdhg.round: read": 10.0, "ladder.resolve": 10.0,
            "ladder.host": 10.0, "outside": 20.0}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want.items()},
                                abs=1e-12)
    assert bench_spans.read_held(trace, _SPANS[3:5]) == 0.5


def test_round_host_and_ladder_split():
    """The span report's parts on the synthetic window: a round's stamped
    and net host time with its launches, and each ladder step's share of
    the panel with the benchmark's certificate capture inside it."""
    trace = Trace(kernels=_KERNELS, host_ops=[
        ("cudaLaunchKernel", 3.0, 3.5), ("cudaLaunchKernel", 5.0, 5.5),
        ("cudaLaunchKernel", 31.0, 31.5), ("cudaLaunchKernel", 32.0, 35.5),
        ("cudaLaunchKernel", 61.0, 61.5)])
    got = bench_spans.round_host(trace, _SPANS[3:5])
    assert got == {"raw": 7.0, "host": pytest.approx(5.5),
                   "waited_us_by_call": {"cudaLaunchKernel": 1.5},
                   "launches": 2.0,
                   "launch_us_p10_p50_p90_p99_max": [0.5, 0.5, 0.5, 0.5,
                                                     3.5]}
    split = bench_spans.ladder_split(trace, _SPANS,
                                     [(40_000, 45_000), (62_000, 64_000)])
    want = {"ladder.first": {"share": 59.0, "s": 59e-6, "solve_s": 57e-6,
                             "cert_s": 5e-6, "cert_idle_s": 5e-6},
            "ladder.resolve": {"share": 20.0, "s": 20e-6, "solve_s": 0.0,
                               "cert_s": 2e-6, "cert_idle_s": 0.0},
            "ladder.host": {"share": 10.0, "s": 10e-6, "solve_s": 0.0,
                            "cert_s": 0.0, "cert_idle_s": 0.0}}
    assert split.keys() == want.keys()
    for step, w in want.items():
        assert split[step] == pytest.approx(w, abs=1e-12), step
