"""Importance sampling in the PyTorch port, held against the JAX package:
``scenario_log_pdf`` and ``sample_importance`` on the same numpy values
(discrete lands, normal transship, a uniform proposal over transship's
positions, values off every support), ``load_proposal``'s position check,
teacher-forced weighted SD steps on lands, and ``SDSolver(proposal=...)``
under the gates of ``tests/test_sampling.py::test_on_device_proposal_run``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.models.scenario as jsc
import sqlp_tpu_torch.models.scenario as tsc
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.models.instance import load_proposal as jax_load_proposal
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance, load_proposal
from sqlp_tpu_torch.sd.driver import SDSolver
from sqlp_tpu_torch.sd.state import state_from_numpy

torch.set_num_threads(1)

# the uniform proposal of tests/test_sampling.py:278-285
LANDS_UNIFORM = (
    "STOCH         LandS\n"
    "INDEP         DISCRETE\n"
    "    RHS       S2C5      3.0                      0.3333333333\n"
    "    RHS       S2C5      5.0                      0.3333333333\n"
    "    RHS       S2C5      7.0                      0.3333333334\n"
    "ENDATA\n")
# a box around each of transship's normal demands (mean +- 2.5 sd)
TRANSSHIP_BOX = "".join(
    [f"STOCH         transship\nINDEP          UNIFORM\n"]
    + [f"    RHS      dummy({i})     {m - 2.5 * s:.5f}     {m + 2.5 * s:.5f}\n"
       for i, (m, s) in enumerate([(100, 20), (200, 50), (150, 30),
                                   (170, 50), (180, 40), (170, 30),
                                   (170, 50)])]
    + ["ENDATA\n"])


def _pair(name):
    return (load_instance(name, dtype=torch.float64, device="cpu"),
            jax_load_instance(name, dtype=jnp.float64))


@pytest.fixture(scope="module")
def lands():
    return _pair("lands")


@pytest.fixture(scope="module")
def transship():
    return _pair("transship")


def _proposals(tmp_path, port, ref, text):
    path = tmp_path / "proposal.sto"
    path.write_text(text)
    return (load_proposal(port, str(path), dtype=torch.float64),
            jax_load_proposal(ref, str(path), dtype=jnp.float64))


def _both_log_pdf(tmodel, jmodel, vals):
    a = tsc.scenario_log_pdf(tmodel, torch.as_tensor(vals)).numpy()
    b = np.asarray(jsc.scenario_log_pdf(jmodel, jnp.asarray(vals)))
    return a, b


def _assert_log_pdf_equal(a, b):
    """Equal -inf where either is off the support, finite values within
    1e-12 relative."""
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    assert np.all(np.isfinite(a) == fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=0.0)


def test_log_pdf_lands_discrete(lands):
    """lands' discrete pmf {0.3, 0.4, 0.3} on its support and at values
    within the 1e-6 relative match tolerance; off the support both
    packages floor the mass at 1e-300: log 1e-300 in f64, and -inf in f32,
    where 1e-300 underflows to 0."""
    port, ref = lands
    rng = np.random.default_rng(3)
    on = rng.choice([3.0, 5.0, 7.0], size=(64, 1))
    near = on * (1.0 + 1e-8 * rng.standard_normal(on.shape))
    off = np.array([[4.0], [0.0], [7.5], [-3.0]])
    vals = np.concatenate([on, near, off])
    a, b = _both_log_pdf(port.scenario_model, ref.scenario_model, vals)
    _assert_log_pdf_equal(a, b)
    np.testing.assert_allclose(np.exp(a[:128]), np.where(
        vals[:128, 0].round() == 5.0, 0.4, 0.3), rtol=1e-12)
    np.testing.assert_array_equal(a[-4:], np.log(1e-300))
    port32 = load_instance("lands", dtype=torch.float32, device="cpu")
    ref32 = jax_load_instance("lands", dtype=jnp.float32)
    a, b = _both_log_pdf(port32.scenario_model, ref32.scenario_model,
                         off.astype(np.float32))
    assert np.all(np.isneginf(a)) and np.all(np.isneginf(b))


def test_log_pdf_transship_continuous(tmp_path, transship):
    """transship's seven normal positions, and a uniform box over the same
    positions (``-inf`` outside it), on the same numpy values."""
    port, ref = transship
    tprop, jprop = _proposals(tmp_path, port, ref, TRANSSHIP_BOX)
    rng = np.random.default_rng(4)
    mean = np.array([100, 200, 150, 170, 180, 170, 170], np.float64)
    sd = np.array([20, 50, 30, 50, 40, 30, 50], np.float64)
    vals = mean + sd * rng.standard_normal((96, 7))
    vals[-3:, 2] = mean[2] + 3.0 * sd[2]          # outside the box
    a, b = _both_log_pdf(port.scenario_model, ref.scenario_model, vals)
    _assert_log_pdf_equal(a, b)
    assert np.all(np.isfinite(a))
    a, b = _both_log_pdf(tprop, jprop, vals)
    _assert_log_pdf_equal(a, b)
    assert np.all(np.isneginf(a[-3:]))


def test_sample_importance_weights_match(tmp_path, monkeypatch, lands,
                                         transship):
    """``sample_importance`` on the same drawn values (each package's
    ``sample_values`` replaced by the numpy draw): the same deltas against
    the target's template and the same weights p_target / p_proposal."""
    rng = np.random.default_rng(5)
    cases = [(lands, LANDS_UNIFORM,
              rng.choice([3.0, 5.0, 7.0], size=(40, 1))),
             (transship, TRANSSHIP_BOX,
              np.array([100, 200, 150, 170, 180, 170, 170.0])
              + rng.uniform(-40.0, 40.0, (40, 7)))]
    for (port, ref), text, vals in cases:
        tprop, jprop = _proposals(tmp_path, port, ref, text)
        monkeypatch.setattr(tsc, "sample_values",
                            lambda *a, **k: torch.as_tensor(vals))
        monkeypatch.setattr(jsc, "sample_values",
                            lambda *a, **k: jnp.asarray(vals))
        gen = torch.Generator().manual_seed(0)
        td, tw = tsc.sample_importance(gen, port.scenario_model, tprop,
                                       len(vals))
        jd, jw = jsc.sample_importance(None, ref.scenario_model, jprop,
                                       len(vals))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12)
        assert np.all(tw.numpy() > 0.0)


def test_load_proposal_position_mismatch(tmp_path, lands):
    """A proposal over another row raises ValueError in both packages."""
    port, ref = lands
    path = tmp_path / "bad.sto"
    path.write_text("STOCH         LandS\n"
                    "INDEP         DISCRETE\n"
                    "    RHS       S2C6      3.0                      1.0\n"
                    "ENDATA\n")
    with pytest.raises(ValueError):
        load_proposal(port, str(path), dtype=torch.float64)
    with pytest.raises(ValueError):
        jax_load_proposal(ref, str(path), dtype=jnp.float64)


_CAP = dict(dtype="float64", max_scenarios=64, max_dual_vertices=64,
            max_cuts=16)


def test_weighted_steps_match_jax_teacher_forced(tmp_path, lands):
    """Five lands steps in f64 on importance-weighted scenarios: values
    drawn once with numpy from the uniform proposal, the port's density
    ratios (equal to the JAX package's) as weights, both fed to each
    package's ``step_scenarios``; each port step starts from the JAX
    state. The states agree within 1e-9, all but ``master_rho``: the ADMM
    penalty, adapted from ratios of the master's residuals, which agrees
    within 1e-6 (1.2e-8 measured) while the master's solution ``master_z``,
    ``master_mu`` agrees within 1e-12."""
    port, ref = lands
    tprop, jprop = _proposals(tmp_path, port, ref, LANDS_UNIFORM)
    x0 = np.full(4, 3.0)
    ps = SDSolver(port, SDConfig(**_CAP), x0=x0, seed=0)
    js = JSDSolver(ref, JSDConfig(**_CAP), x0=x0, seed=0)
    vals = np.random.default_rng(7).choice([3.0, 5.0, 7.0], size=(5, 1, 1, 1))
    fields = [f.name for f in dataclasses.fields(ps.state)]
    for i, v in enumerate(vals):
        logw = (tsc.scenario_log_pdf(port.scenario_model, torch.as_tensor(v))
                - tsc.scenario_log_pdf(tprop, torch.as_tensor(v)))
        w = torch.exp(logw).numpy()
        jw = np.exp(np.asarray(jsc.scenario_log_pdf(ref.scenario_model, v)
                               - jsc.scenario_log_pdf(jprop, v)))
        np.testing.assert_allclose(w, jw, rtol=1e-12)
        ps.state = state_from_numpy(
            {f: np.asarray(getattr(js.state, f)) for f in fields}, ps.state)
        ps.step_scenarios(values=v, weights=w)
        js.step_scenarios(values=v, weights=w)
        for f in fields:
            got = getattr(ps.state, f).numpy().astype(np.float64)
            want = np.asarray(getattr(js.state, f)).astype(np.float64)
            tol = 1e-6 if f == "master_rho" else 1e-9
            np.testing.assert_allclose(
                got, want, rtol=tol, atol=tol * (1.0 + np.abs(
                    np.nan_to_num(want)).max()), err_msg=f"step {i} {f}")
    assert float(ps.state.total_weight[0]) == pytest.approx(
        float(np.sum(np.where(vals[:, 0, 0, 0] == 5.0, 1.2, 0.9))),
        rel=1e-9)


def test_weights_with_proposal_raise(tmp_path, lands):
    """A proposal computes its own weights: passing both raises
    ValueError, not a bare assert."""
    from sqlp_tpu_torch.sd.algorithm import sd_step
    port, ref = lands
    tprop, _ = _proposals(tmp_path, port, ref, LANDS_UNIFORM)
    s = SDSolver(port, SDConfig(**_CAP), x0=np.full(4, 3.0), seed=0)
    with pytest.raises(ValueError, match="proposal"):
        sd_step(s.arrays, s.scenario_model, s.espec, s.prep_sub, s.state,
                s.config, s.generator,
                weights=torch.ones((1, 1), dtype=torch.float64),
                proposal=tprop)


def test_solver_proposal_run_lands(tmp_path, lands):
    """``SDSolver(proposal=...)`` on lands, the reference's gates
    (tests/test_sampling.py::test_on_device_proposal_run): 200 iterations
    drawn from the uniform proposal, stored weights the exact ratios
    {0.9, 1.2}, the total weight within 0.15 of one per iteration, the
    lower estimate in 370-390. The solvers' tolerances are the port's
    defaults (the reference test's tighter ones take 1.6 times as long on
    the CPU)."""
    port, ref = lands
    tprop, _ = _proposals(tmp_path, port, ref, LANDS_UNIFORM)
    cfg = SDConfig(dtype="float64", max_scenarios=256, max_dual_vertices=128,
                   max_cuts=16, quad_schedule="constant",
                   quad_scalar_init=0.1)
    s = SDSolver(port, cfg, x0=np.full(4, 3.0), seed=6, proposal=tprop)
    s.run(200)
    assert 370 < s.lower_estimate < 390, s.lower_estimate
    n = int(s.state.n_scen[0])
    w = s.state.scen_weights[0, :n].numpy()
    assert set(np.round(w, 6)) <= {0.9, 1.2}, np.unique(w)
    assert abs(float(s.state.total_weight[0]) / 200 - 1.0) < 0.15
    assert int(s.state.n_stream[0]) == 200
