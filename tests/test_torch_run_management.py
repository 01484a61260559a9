"""Run management in the PyTorch port: checkpoint / resume, the JSONL
metrics sink, the profiler hook and the CLI flags that drive them, held
against the JAX package's ``utils`` where both have the feature
(``tests/test_utils_aux.py``'s cases) and across the two packages' files.
"""

import dataclasses
import glob
import json
import os
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.utils.checkpoint as jckpt
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from sqlp_tpu_torch.cli import main
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.driver import SDReplications, SDSolver
from sqlp_tpu_torch.sd.state import SDState
from sqlp_tpu_torch.utils.checkpoint import (GENERATOR_FIELD, load_meta,
                                             load_state, save_state)
from sqlp_tpu_torch.utils.metrics import MetricsLogger
from sqlp_tpu_torch.utils.profiling import span, trace

from test_torch_importance import LANDS_UNIFORM

torch.set_num_threads(1)

_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)
FIELDS = [f.name for f in dataclasses.fields(SDState)]


@pytest.fixture(scope="module")
def lands():
    return load_instance("lands", dtype=torch.float64, device="cpu")


def _solver(inst, seed=5, **kw):
    return SDSolver(inst, SDConfig(**{**_CAP, **kw}), x0=np.full(4, 3.0),
                    seed=seed)


def _assert_states_equal(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def test_resume_is_bitwise(tmp_path, lands):
    """lands f64: k iterations, save, load into a solver seeded otherwise,
    k more, against 2k straight: every state field and the generator's
    state bit for bit, and the metadata round-trips."""
    k = 6
    path = str(tmp_path / "ckpt.npz")
    u = _solver(lands)
    u.run(2 * k)
    a = _solver(lands)
    a.run(k)
    save_state(path, a.state, a.generator, instance="lands")
    b = _solver(lands, seed=99)
    b.state = load_state(path, template=b.state, generator=b.generator)
    assert int(b.state.it) == k
    b.run(k)
    _assert_states_equal(u.state, b.state)
    assert torch.equal(u.generator.get_state(), b.generator.get_state())
    assert load_meta(path) == {"instance": "lands"}
    with np.load(path) as z:
        assert z[GENERATOR_FIELD].dtype == np.uint8
        np.testing.assert_array_equal(z["key"], np.array([0, 5], np.uint32))


def test_wrong_capacity_raises(tmp_path, lands):
    path = str(tmp_path / "ckpt.npz")
    a = _solver(lands)
    save_state(path, a.state, a.generator)
    small = _solver(lands, max_cuts=8)
    with pytest.raises(ValueError, match="capacities must match"):
        load_state(path, template=small.state)


def _strip(path, *names, **put):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if k not in names}
    payload.update(put)
    np.savez(path, **payload)


def test_missing_scalar_field_defaults(tmp_path, lands):
    """A file without a scalar field (``master_rho``) loads with the
    template's value and a warning; a missing array field raises
    (tests/test_utils_aux.py:68-105)."""
    path = str(tmp_path / "ckpt.npz")
    a = _solver(lands)
    a.run(3)
    save_state(path, a.state, a.generator)
    _strip(path, "master_rho")
    b = _solver(lands)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        b.state = load_state(path, template=b.state)
    assert any("master_rho" in str(x.message) for x in w)
    assert float(b.state.master_rho) == float(_solver(lands).state.master_rho)
    assert torch.equal(b.state.x_candidate, a.state.x_candidate)
    _strip(path, "x_candidate", master_rho=np.asarray(0.1))
    with pytest.raises(ValueError, match="x_candidate"):
        load_state(path, template=_solver(lands).state)


def test_pre_weighted_stream_defaults(tmp_path, lands):
    """A file without ``n_stream`` restores it as the total weight (unit
    weights), and the resumed run still matches a straight one bit for bit
    (tests/test_utils_aux.py:108-133)."""
    path = str(tmp_path / "ckpt.npz")
    a = _solver(lands)
    a.run(4)
    save_state(path, a.state, a.generator)
    _strip(path, "n_stream")
    b = _solver(lands)
    b.state = load_state(path, template=b.state, generator=b.generator)
    assert torch.equal(b.state.n_stream, a.state.total_weight.to(torch.int32))
    a.run(3)
    b.run(3)
    _assert_states_equal(a.state, b.state)


def test_legacy_cut_x_defaults(tmp_path, lands):
    """A file without ``cut_x`` defaults each cut's generating point to
    the incumbent: single states [E, K, n1] and stacked replications [R,
    E, K, n1], with and without a template
    (tests/test_utils_aux.py:156-175)."""
    a = _solver(lands)
    a.run(2)
    reps = SDReplications(lands, SDConfig(**_CAP), n_replications=2, seed=0,
                          x0=np.full(4, 3.0))
    reps.run(2)
    for name, state, template in (("single", a.state, a.state),
                                  ("stacked", reps.state, None)):
        path = str(tmp_path / f"{name}.npz")
        save_state(path, state)
        _strip(path, "cut_x")
        restored = load_state(path, template=template)
        xi = state.x_incumbent
        want = xi[..., None, None, :].expand(state.cut_x.shape)
        assert torch.equal(restored.cut_x, want.to(restored.cut_x.dtype))


def test_files_cross_between_packages(tmp_path, lands):
    """A file the JAX package wrote loads in the port with equal fields
    (its generator kept seeded, with a warning); a file the port wrote
    loads in the JAX package's ``load_state`` with equal fields and the
    PRNG key layout of the port's seed."""
    ref = jax_load_instance("lands", dtype=jnp.float64)
    js = JSDSolver(ref, JSDConfig(**_CAP), x0=np.full(4, 3.0), seed=0)
    vals = np.random.default_rng(2).choice([3.0, 5.0, 7.0], (2, 1, 1, 1))
    for v in vals:
        js.step_scenarios(values=v)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_state(jpath, js.state, instance="lands")
    ps = _solver(lands, seed=0)
    before = ps.generator.get_state()
    with pytest.warns(UserWarning, match="generator"):
        ps.state = load_state(jpath, template=ps.state,
                              generator=ps.generator)
    assert torch.equal(ps.generator.get_state(), before)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ps.state, f).numpy(),
                                      np.asarray(getattr(js.state, f)),
                                      err_msg=f)
    assert load_meta(jpath) == {"instance": "lands"}

    ps = _solver(lands, seed=7)
    ps.run(2)
    tpath = str(tmp_path / "port.npz")
    save_state(tpath, ps.state, ps.generator, instance="lands")
    loaded = jckpt.load_state(tpath, template=js.state)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)),
                                      getattr(ps.state, f).numpy(),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(loaded.key), [0, 7])
    assert jckpt.load_meta(tpath) == {"instance": "lands"}


def test_metrics_logger_matches_jax(tmp_path):
    """The same stats through both packages' loggers: the same records
    (tensors, arrays, bools, non-finite and non-scalar values), wall clock
    aside."""
    stats = [({"it": 1, "cand_est": 2.5, "is_improved": True,
               "x_candidate": np.zeros(4)}, {"tag": "t"}),
             ({"it": 2, "bad": float("nan"), "inf": float("inf"),
               "n": np.int32(3)}, {}),
             ({"it": 3, "sharpen": {"n_solved": 2}}, {})]
    paths = [str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")]
    with MetricsLogger(paths[0]) as tl, JMetricsLogger(paths[1]) as jl:
        for st, extra in stats:
            tl.log({k: torch.as_tensor(v) if isinstance(
                v, (float, bool, np.ndarray)) else v
                for k, v in st.items()}, **extra)
            jl.log({k: jnp.asarray(v) if isinstance(
                v, (float, bool, np.ndarray)) else v
                for k, v in st.items()}, **extra)
    recs = [[json.loads(line) for line in open(p)] for p in paths]
    for r in recs:
        for rec in r:
            assert isinstance(rec.pop("wall_s"), float)
    assert recs[0] == recs[1]
    assert recs[0][0] == {"it": 1, "cand_est": 2.5, "is_improved": True,
                          "tag": "t"}
    assert MetricsLogger(None).log({"it": 4})["it"] == 4


def test_trace_none_and_phase_timers(tmp_path):
    """``trace(None)`` profiles nothing; ``trace(dir)`` writes the Chrome
    trace and, beside it, the spans recorded in the block (which took the
    phase timers' place) on the Unix ns clock; outside it a span records
    nothing."""
    import time

    from sqlp_tpu_torch.config import PDHGConfig
    from sqlp_tpu_torch.ops.pdhg import prepare_lp, solve_batch
    with trace(None) as prof:
        assert prof is None
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    a = inst.arrays
    lp = prepare_lp(a.W, a.senses2, a.q, a.lb2, a.ub2)
    t0 = time.time_ns()
    with trace(str(tmp_path)) as prof:
        assert prof is not None
        _, _, _, st = solve_batch(lp, a.r[None, :].repeat(2, 1),
                                  PDHGConfig(max_iters=240))
    t1 = time.time_ns()
    (chrome,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    (path,) = glob.glob(str(tmp_path / "*.spans.json"))
    assert chrome[:-len(".pt.trace.json")] == path[:-len(".spans.json")]
    with open(path) as f:
        got = json.load(f)
    assert got["clock"] == "unix_ns"
    sp = got["spans"]
    assert [s["name"] for s in sp] == \
        ["pdhg.solve"] + ["pdhg.round"] * st["pdhg_rounds"]
    assert sp[0]["parent"] == -1 and sp[0]["attrs"]["B"] == 2
    assert all(s["parent"] == 0 and t0 <= s["start"] <= s["end"] <= t1
               for s in sp[1:])
    assert not span("outside")


# the CLI on lands at fixed capacities: --resume checks shapes, and
# autoscaling follows --iters
_CLI = ["solve", "lands", "--device", "cpu", "--dtype", "float64",
        "--no-auto-capacity", "--max-scenarios", "64", "--max-duals", "64",
        "--max-cuts", "16", "--eval-samples", "128"]


def _fields(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cli_log_checkpoint_resume(tmp_path, capsys):
    """U: 16 iterations, logged every 4 into JSONL and checkpointed every
    6 (saves at 6 and 12, and at the end); A: 8 iterations; B: resumes A
    for 8 more. B's file equals U's bit for bit (state and generator), as
    do the final bounds; U's log holds 4 period records and a final one;
    the saves land at the multiples of --checkpoint-every."""
    u, a, b = (str(tmp_path / f"{k}.npz") for k in "UAB")
    log = str(tmp_path / "U.jsonl")
    assert main(_CLI + ["--iters", "16", "--log-every", "4", "--log", log,
                        "--checkpoint", u, "--checkpoint-every", "6"]) == 0
    out_u = capsys.readouterr().out
    assert main(_CLI + ["--iters", "8", "--checkpoint", a]) == 0
    capsys.readouterr()
    assert main(_CLI + ["--iters", "8", "--resume", a,
                        "--checkpoint", b]) == 0
    out_b, err_b = capsys.readouterr()
    assert "resumed from" in err_b and "at iter 8" in err_b
    fu, fb = _fields(u), _fields(b)
    assert set(fu) == set(fb) and GENERATOR_FIELD in fu
    for k in fu:
        np.testing.assert_array_equal(fu[k], fb[k], err_msg=k)
    bounds = [re.search(r"lb_est=(\S+) mc_ub=(\S+)", o).groups()
              for o in (out_u, out_b)]
    assert bounds[0] == bounds[1]
    recs = [json.loads(line) for line in open(log)]
    assert [r["it"] for r in recs] == [4, 8, 12, 16, 16]
    assert recs[-1]["final"] is True and "mc_upper_bound" in recs[-1]
    assert all("final" not in r for r in recs[:4])


def test_cli_checkpoint_cadence(tmp_path, monkeypatch):
    """--checkpoint-every 4 --eval-every 3 over 9 iterations saves at 4
    and 8 (the chunks end at every multiple of either period), then at
    the end."""
    import sqlp_tpu_torch.utils.checkpoint as ck
    saved = []
    real = ck.save_state
    monkeypatch.setattr(ck, "save_state", lambda p, st, *a, **k: (
        saved.append(int(st.it)), real(p, st, *a, **k)))
    assert main(_CLI + ["--iters", "9", "--checkpoint",
                        str(tmp_path / "c.npz"), "--checkpoint-every", "4",
                        "--eval-every", "3"]) == 0
    assert saved == [4, 8, 9]


def test_cli_proposal_and_profile(tmp_path, capsys):
    """--proposal-sto on lands with --checkpoint and --profile: the stored
    weights are the exact ratios {0.9, 1.2}, the total weight is their
    sum over the stream, the bounds are finite, and the profiler wrote a
    Chrome trace naming the run's operators."""
    prop = tmp_path / "prop.sto"
    prop.write_text(LANDS_UNIFORM)
    ck = str(tmp_path / "is.npz")
    prof = str(tmp_path / "prof")
    assert main(_CLI + ["--iters", "3", "--proposal-sto", str(prop),
                        "--checkpoint", ck, "--profile", prof,
                        "--master-iters", "200"]) == 0
    out, err = capsys.readouterr()
    assert "importance sampling from proposal" in err
    lb, ub = map(float, re.search(r"lb_est=(\S+) mc_ub=(\S+)", out).groups())
    assert np.isfinite(lb) and np.isfinite(ub)
    f = _fields(ck)
    n = int(f["n_scen"][0])
    w = f["scen_weights"][0, :n]
    assert n == 3 and set(np.round(w, 6)) <= {0.9, 1.2}
    assert f["total_weight"][0] == pytest.approx(w.sum(), rel=1e-12)
    traces = glob.glob(os.path.join(prof, "*.pt.trace.json*"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("flag", [
    ["--log", "x.jsonl"], ["--checkpoint", "x.npz"],
    ["--checkpoint-every", "10"], ["--resume", "x.npz"],
    ["--profile", "prof"]])
def test_cli_refuses_run_management_with_replications(flag, capsys):
    """Each run-management flag with --replications 3 exits 2 before any
    work, with a message (the reference's replicated path ignores them
    silently)."""
    assert main(["solve", "lands", "--device", "cpu", "--replications",
                 "3", *flag]) == 2
    err = capsys.readouterr().err
    assert f"{flag[0]} is not supported with --replications > 1" in err
