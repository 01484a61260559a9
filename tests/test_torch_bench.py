"""The port's bench (``sqlp_tpu_torch/bench.py``) against the reference
``bench.py`` at the repo's root, imported here only.

The sections' glue runs on stub solvers that give both packages the same
numbers (numpy in the JAX package's stubs, CPU torch tensors in the
port's): the returned dicts must be equal but for their wall clocks, and
the stubs must be called with equal arguments. ``run`` must pass each
section the arguments the reference's ``child`` passes on the TPU and on
the CPU. One section runs for real: the throughput on transship at
B = 16 on the CPU. Last, the output contract: one flushed line per
section, the reference's object last, exit 1 after a failed section, 2
without a card."""

import argparse
import ast
import dataclasses
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import sqlp_tpu.cli as jax_cli
import sqlp_tpu.config as jax_config
import sqlp_tpu.models.instance as jax_instance
import sqlp_tpu.sd.compromise as jax_compromise
import sqlp_tpu.sd.driver as jax_driver
import sqlp_tpu_torch.config as config
import sqlp_tpu_torch.models.instance as instance
import sqlp_tpu_torch.sd.compromise as compromise
import sqlp_tpu_torch.sd.driver as driver
from sqlp_tpu_torch import bench, cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_bench():
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_bench()


def _wall(key: str) -> bool:
    return key in ("sd_wallclock_s", "sd_iters_per_sec") \
        or key.endswith("_wall_s")


def _fields(cfg) -> dict:
    """A config's fields that the port's class of the same name has
    (the JAX classes add their Pallas switches), nested configs too."""
    template = dataclasses.asdict(getattr(config, type(cfg).__name__)())

    def keep(d, t):
        return {k: keep(v, t[k]) if isinstance(v, dict) else v
                for k, v in d.items() if k in t}
    return keep(dataclasses.asdict(cfg), template)


def _plain(v):
    """Arrays and tensors as lists, configs as their shared fields."""
    if dataclasses.is_dataclass(v):
        return _fields(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _dname(dtype) -> str:
    """A torch or a numpy / JAX dtype's name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


class _Inst:
    """A loaded instance as the sections see it: its name, its device."""

    def __init__(self, name):
        self.name = name
        self.device = torch.device("cpu")


X_EF = np.linspace(0.0, 1.0, 16 * 5).reshape(16, 5)
X_COMP = np.array([0.5, 0.25, 0.0, 1.0, 0.75])


def _stubs(calls, array):
    """SDSolver, SDReplications and compromise_decision stand-ins that
    record their calls in ``calls`` and return fixed numbers, their arrays
    made by ``array`` (numpy or torch)."""

    class Solver:
        def __init__(self, inst, cfg, seed=0, **kw):
            calls.append(["SDSolver", inst.name, _fields(cfg), seed, kw])
            self.history = []
            self.host_fallback_count = 3

        def run(self, n_iters, log_every=0, **kw):
            calls.append(["run", n_iters, log_every, kw])
            self.history += [{"cand_est": array(np.array(9.5 + 0.001 * i))}
                             for i in range(n_iters if log_every else 0)]
            return {}

        lower_estimate = 9.7654321

        def evaluate_ci(self, x=None, **kw):
            calls.append(["evaluate_ci", _plain(x), kw])
            return 9.876543, 0.0123456, kw.get("min_samples")

    class Replications(Solver):
        def __init__(self, inst, cfg, n_replications=2, seed=0, **kw):
            calls.append(["SDReplications", inst.name, _fields(cfg),
                          n_replications, seed, kw])
            self.n = n_replications
            self.history = []
            self.host_fallback_count = 5
            self.states = [f"state{r}" for r in range(n_replications)]
            self.especs = [f"espec{r}" for r in range(n_replications)]
            self.obj_scale = 2.5

        def certified_lower_bound(self, method="ef", **kw):
            calls.append(["certified_lower_bound", method, kw])
            lb = 9.0 + 0.1 * np.arange(self.n)
            out = {"lb_cert": 8.9, "lb_mean": 9.15, "lb_half_width": 0.25,
                   "lb_per_rep": array(lb),
                   "dual_infeas_per_rep": array(np.full(self.n, 1e-12))}
            if method == "ef":
                out.update(x_ef_per_rep=array(X_EF[:self.n]),
                           ef_err_per_rep=array(np.full(self.n, 9e-6)),
                           n_scenarios=kw.get("fresh_scenarios"))
            return out

        def select_decision(self, candidates, n_samples=16384, seed=31000):
            calls.append(["select_decision", _plain(candidates), n_samples,
                          seed])
            table = {k: (10.0 - i, 0.5 + i, 0.0)
                     for i, k in enumerate(candidates)}
            name = list(candidates)[-1]
            return {"name": name, "x": candidates[name], "table": table}

        def solve_to_certified_gap(self, target_gap, **kw):
            calls.append(["solve_to_certified_gap", target_gap, kw])
            return {"it": 200, "route": "polish", "lb_cert": 381.5,
                    "cert_gap": 0.0098, "stopped": True, "iters": 200,
                    "time_to_certified_gap_s": 85.7,
                    "x_compromise": array(X_COMP[:4]), "rounds": [{}]}

    def compromise_decision(inst, states, especs, rho=1.0, qp_config=None,
                            obj_scale=1.0):
        calls.append(["compromise_decision", inst.name, states, especs, rho,
                      _fields(qp_config), obj_scale])
        return X_COMP, {}

    return Solver, Replications, compromise_decision


@pytest.fixture
def stubbed(monkeypatch):
    """Stubs in both packages; returns the two call lists."""
    jcalls, calls = [], []
    for mod_driver, mod_comp, got, array in (
            (jax_driver, jax_compromise, jcalls, np.asarray),
            (driver, compromise, calls, torch.as_tensor)):
        Solver, Replications, comp = _stubs(got, array)
        monkeypatch.setattr(mod_driver, "SDSolver", Solver)
        monkeypatch.setattr(mod_driver, "SDReplications", Replications)
        monkeypatch.setattr(mod_comp, "compromise_decision", comp)

    def load(got):
        def load_instance(name, dtype=None, **kw):
            got.append(["load_instance", name, _dname(dtype)])
            return _Inst(name)
        return load_instance
    monkeypatch.setattr(jax_instance, "load_instance", load(jcalls))
    monkeypatch.setattr(instance, "load_instance", load(calls))
    return jcalls, calls


def _jax_config(instance_name):
    """The reference child's configuration of an instance
    (bench.py:403-405, 431-432)."""
    kw = {"quad_schedule": "adaptive", "quad_scalar_init": 1e-3} \
        if instance_name == "ssn" else {}
    return jax_config.SDConfig(pdhg=jax_config.PDHGConfig(
        tol=1e-4, max_iters=80_000), **kw)


def _same(got, want):
    assert {k: v for k, v in got.items() if not _wall(k)} == \
        {k: v for k, v in want.items() if not _wall(k)}


@pytest.mark.parametrize("name", ["ssn", "storm"])
def test_configs_match_reference(name):
    assert _fields(bench._config(name)) == _fields(_jax_config(name))


@pytest.mark.parametrize("n_iters", [150, 3000])
def test_sd_gap_matches_reference(stubbed, n_iters):
    """The warm run, the timed run, the trailing mean over the last 100
    iterations and the 8192-sample stratified bound at seed 7."""
    jcalls, calls = stubbed
    want = ref._bench_sd_gap(_Inst("ssn"), _jax_config("ssn"), n_iters)
    got = bench._plain(bench._bench_sd_gap(_Inst("ssn"), bench._config("ssn"),
                                           n_iters))
    _same(got, want)
    assert tuple(got) == chip_smoke.BENCH_KEYS["sd_gap"]
    assert _plain(calls) == _plain(jcalls)
    assert [c[1:3] for c in calls if c[0] == "run"] == \
        [[min(n_iters, 256), 0], [n_iters, 1]]
    assert json.dumps(got)


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
@pytest.mark.parametrize("section", ["storm_certified", "ssn_certified"])
def test_certified_matches_reference(stubbed, section, backend):
    """Both routes (the model route on storm; the EF route on ssn, with
    antithetic pairing at the card's depth): the certification's
    arguments, the candidates and their selection panel, the winner's
    panel, and the returned dict."""
    jcalls, calls = stubbed
    kw = bench.DEPTHS[backend][section]
    iname = bench._INSTANCE[section]
    want = ref._bench_certified(_Inst(iname), _jax_config(iname), **kw)
    got = bench._plain(bench._bench_certified(
        _Inst(iname), bench._config(iname), **kw))
    _same(got, want)
    assert tuple(got) == chip_smoke.BENCH_KEYS["certified"]
    assert _plain(calls) == _plain(jcalls)
    names = [c[1] for c in calls if c[0] == "select_decision"]
    if section == "ssn_certified":
        assert list(names[0]) == (
            ["compromise", "ef_avg", "ef_0", "ef_2", "ef_4"]
            if backend == "cuda" else ["compromise", "ef_avg", "ef_0"])
    else:
        assert names == []
    json.dumps(got)


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_target_gap_matches_reference(stubbed, backend):
    """lands at each depth: the configuration, the replications and every
    argument of solve_to_certified_gap; the record less x_compromise and
    rounds."""
    jcalls, calls = stubbed
    want = ref._bench_target_gap(on_tpu=backend == "cuda")
    got = bench._plain(bench._bench_target_gap(
        torch.device("cpu"), **bench.DEPTHS[backend]["lands_target_gap"]))
    _same(got, want)
    assert _plain(calls) == _plain(jcalls)
    assert [c[0] for c in calls] == ["load_instance", "SDReplications",
                                    "solve_to_certified_gap"]


def _recorders(mod, got):
    """Section stand-ins for ``mod`` that record their bound arguments."""
    out = {}
    for fn in ("_bench_throughput", "_bench_sd_gap", "_bench_certified",
               "_bench_target_gap"):
        sig = inspect.signature(getattr(mod, fn))

        def rec(*a, _fn=fn, _sig=sig, **kw):
            b = _sig.bind(*a, **kw)
            b.apply_defaults()
            args = dict(b.arguments)
            inst = args.pop("inst", None)
            args.pop("device", None)
            got.append([_fn, getattr(inst, "name", None),
                        _plain(args.pop("config", None)), args])
            if _fn == "_bench_throughput":
                return {"throughput": 1000.0, "baseline": 10.0,
                        "baseline_runs": [9.0, 10.0, 11.0, 12.0, 13.0],
                        "batch": args["B"], "max_rel_err_vs_highs": 1e-7}
            return {"section_of": _fn}
        out[fn] = rec
    return out


@pytest.mark.parametrize("backend", ["cuda", "cpu"])
def test_run_passes_reference_depths(stubbed, monkeypatch, capsys, backend):
    """``run`` on ``backend`` calls each section with the arguments the
    reference's ``child`` gives it on the TPU / the CPU, and its last line
    is the reference's object (but for the backend's name)."""
    jcalls, calls = [], []
    for mod, got in ((ref, jcalls), (bench, calls)):
        for fn, rec in _recorders(mod, got).items():
            monkeypatch.setattr(mod, fn, rec)
    platform = "tpu" if backend == "cuda" else "cpu"
    assert ref.child(argparse.Namespace(platform=platform,
                                        skip_sd_gap=False)) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench.run(torch.device(backend)) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = json.loads(lines[-1])
    assert [json.loads(ln)["section"] for ln in lines[:-1]] == \
        list(bench.SECTIONS)
    # the reference's lands section takes on_tpu; the port its depths
    on_tpu = jcalls[-1][3].pop("on_tpu")
    assert calls[-1][3] == bench.DEPTHS["cuda" if on_tpu else "cpu"][
        "lands_target_gap"]
    calls[-1][3] = {}
    assert calls == jcalls
    assert tuple(k for k in got if k not in bench.SECTIONS
                 and k != "note") == chip_smoke.BENCH_KEYS["final"]
    assert (want.pop("backend"), got.pop("backend")) == (platform, backend)
    assert ("note" in got) == ("note" in want) == (backend == "cpu")
    got.pop("note", None)
    want.pop("note", None)
    assert got == want


def test_throughput_on_transship_matches_reference_keys():
    """The real section on transship (feasible at x = 0) at B = 16 on the
    CPU in both packages: the reference's keys, the HiGHS spot check
    below 1e-3, positive rates."""
    jcfg, cfg = _jax_config("ssn"), bench._config("ssn")
    want = ref._bench_throughput(
        jax_instance.load_instance("transship", dtype=jcfg.jdtype), jcfg, 16)
    got = bench._plain(bench._bench_throughput(
        instance.load_instance("transship", dtype=cfg.jdtype, device="cpu"),
        cfg, 16))
    assert tuple(got) == tuple(want) == chip_smoke.BENCH_KEYS["throughput"]
    assert got["batch"] == want["batch"] == 16
    assert got["max_rel_err_vs_highs"] < 1e-3
    assert want["max_rel_err_vs_highs"] < 1e-3
    assert got["throughput"] > 0.0 and got["baseline"] > 0.0
    assert len(got["baseline_runs"]) == 5
    json.dumps(got)


_CONTRACT = """
import json, os, sys
import sqlp_tpu_torch.models.instance as instance
from sqlp_tpu_torch import bench

out_path, raising = sys.argv[1], sys.argv[2]
instance.load_instance = lambda name, dtype=None, device=None: name


def stub(name, result):
    def fn(*a, **kw):
        with open(out_path) as fh:
            seen = [json.loads(ln).get("section") for ln in fh]
        print(json.dumps({"stub": name, "seen": seen}), file=sys.stderr,
              flush=True)
        if name == raising:
            raise RuntimeError("boom")
        return result
    return fn


thr = {"throughput": 100.0, "baseline": 10.0, "baseline_runs": [10.0] * 5,
       "batch": 512, "max_rel_err_vs_highs": 1e-7}
sd_order = iter(["ssn_time_to_gap", "storm_time_to_gap"])
cert_order = iter(["storm_certified", "ssn_certified"])
bench._bench_throughput = stub("throughput", thr)
sd = {n: stub(n, {"of": n}) for n in ("ssn_time_to_gap",
                                        "storm_time_to_gap")}
cert = {n: stub(n, {"of": n}) for n in ("storm_certified",
                                          "ssn_certified")}
bench._bench_sd_gap = lambda *a, **k: sd[next(sd_order)](*a, **k)
bench._bench_certified = lambda *a, **k: cert[next(cert_order)](*a, **k)
bench._bench_target_gap = stub("lands_target_gap", {"of": "lands"})
sys.exit(bench.main(["--cpu-baseline-only"]))
"""


@pytest.mark.parametrize("raising", ["none", "storm_time_to_gap",
                                     "throughput"])
def test_one_flushed_line_per_section(tmp_path, raising):
    """Stdout to a file (block-buffered): each section sees every earlier
    section's line already in the file when it starts; a raising section
    prints its error line and the later ones still run; the reference's
    object comes last; exit 1 after a failure, else 0."""
    out = tmp_path / "out.jsonl"
    # buffered stdout, as a pipe or a file gets it by default
    env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
    with open(out, "w") as fh:
        proc = subprocess.run(
            [sys.executable, "-c", _CONTRACT, str(out), raising], cwd=ROOT,
            stdout=fh, stderr=subprocess.PIPE, text=True, env=env,
            timeout=120)
    assert proc.returncode == (0 if raising == "none" else 1), proc.stderr
    seen = [json.loads(ln) for ln in proc.stderr.splitlines()
            if ln.startswith('{"stub"')]
    assert [s["stub"] for s in seen] == list(bench.SECTIONS)
    for i, s in enumerate(seen):
        assert s["seen"] == list(bench.SECTIONS[:i])
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [ln.get("section") for ln in lines] == list(bench.SECTIONS) + \
        [None]
    final = lines[-1]
    assert final["metric"] == "ssn_subproblems_per_sec_per_chip"
    assert final["backend"] == "cpu" and "note" in final
    for ln in lines[:-1]:
        if ln["section"] == raising:
            assert ln == {"section": raising, "error": "RuntimeError: boom"}
    if raising == "throughput":
        assert final["error"] == "RuntimeError: boom" and "value" not in final
    elif raising != "none":
        assert final[raising] == {"error": "RuntimeError: boom"}
        assert final["value"] == 100.0


@pytest.mark.parametrize("flags", [[], ["--skip-sd-gap"]])
def test_bench_without_card_exits_2(monkeypatch, capsys, flags):
    """Without a card and without --cpu-baseline-only the subcommand
    prints the CLI's device error and exits 2 before any section."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_section(*a, **k):
        raise AssertionError("a section ran")
    monkeypatch.setattr(bench, "run_section", no_section)
    assert cli.main(["bench", *flags]) == 2
    captured = capsys.readouterr()
    assert "torch.cuda.is_available() is False" in captured.err
    assert captured.out == ""


def _subcommands(parser):
    return {a for act in parser._actions
            if isinstance(act, argparse._SubParsersAction)
            for a in act.choices}


def test_both_clis_have_the_same_subcommands():
    assert _subcommands(cli.build_parser()) == \
        _subcommands(jax_cli.build_parser()) == \
        {"solve", "ef", "evaluate", "bench"}
    args = cli.build_parser().parse_args(["bench", "--skip-sd-gap"])
    assert (args.skip_sd_gap, args.cpu_baseline_only) == (True, False)


def test_bench_module_imports_no_reference_and_starts_no_process():
    """No JAX, no JAX package, no root bench.py, no subprocess or process
    pool: the port's bench runs in its own process on the device asked."""
    with open(bench.__file__) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names] + \
        [node.module for node in ast.walk(tree)
         if isinstance(node, ast.ImportFrom)]
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "sqlp_tpu", "bench", "subprocess",
            "multiprocessing", "concurrent")]
    assert not bad, bad
    assert not any(hasattr(bench, f) for f in
                   ("probe_backend", "run_child", "orchestrate", "child"))
