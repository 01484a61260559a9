"""The level bundle on ssn (89 first-stage variables) against the JAX
package: ``saa_polish`` of both packages on the same SD states and the
same injected fresh streams, in float64 on the CPU.

On fresh streams the SD cuts leave the bound model, and the few bundle
cuts of three rounds leave its minimum over ssn's first stage at the
epigraph floor lb_e = 0 in both packages; the card's ``cert_polish``
phase reads the same floor at 8 x 3000 scenarios. The recourse solves
run at tol 1e-4 (the flagship setting) to keep the test short.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sqlp_tpu.sd.lower_bound as jax_lb
import sqlp_tpu_torch.sd.lower_bound as lb
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu_torch.config import SDConfig
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.sd.driver import SDSolver

from test_torch_lower_bound import _CAP, R, _jax_states_to_port, _streams

torch.set_num_threads(1)

N_CERT = 32
ROUNDS = 3


def _tol(cfg, tol):
    return dataclasses.replace(cfg, pdhg=dataclasses.replace(cfg.pdhg,
                                                             tol=tol))


@pytest.fixture(scope="module")
def ssn_pair():
    """R = 2 JAX SD runs of 3 iterations (seeds 0, 1) carried into the
    port; both packages' polish over one injected 32-scenario stream per
    replication, 3 rounds."""
    js = [JSDSolver(jax_load_instance("ssn", dtype=jnp.float64),
                    JSDConfig(**_CAP), seed=r) for r in range(R)]
    for j in js:
        j.run(3)
    ps = SDSolver(load_instance("ssn", dtype=torch.float64, device="cpu"),
                  SDConfig(**_CAP), seed=0)
    states = _jax_states_to_port([j.state for j in js], ps.state)
    deltas = _streams(ps.inst, N_CERT, seed=11)
    mp = pytest.MonkeyPatch()
    for mod in (lb, jax_lb):
        mp.setattr(mod, "_certification_streams",
                   lambda *a, **k: (deltas, np.ones(deltas.shape[:3]),
                                    False))
    kw = dict(fresh_scenarios=N_CERT, max_rounds=ROUNDS)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = jax_lb.saa_polish(
                js[0].arrays, js[0].scenario_model, js[0].espec,
                js[0].prep_sub, [j.state for j in js],
                _tol(js[0].config, 1e-4), obj_scale=js[0].obj_scale, **kw)
            got = lb.saa_polish(ps.arrays, ps.scenario_model, ps.espec,
                                ps.prep_sub, states, _tol(ps.config, 1e-4),
                                obj_scale=ps.obj_scale, **kw)
    finally:
        mp.undo()
    return ref, got


def test_saa_polish_on_ssn_matches_jax(ssn_pair):
    """Every cut (round 1 at the incumbents, then the projection and the
    Kelley point of rounds 2 and 3): alpha at 1e-6 relative, beta at 1e-5
    absolute (|beta| up to 1): ssn's recourse duals are degenerate, so the
    two PDHG solves stop at optimal duals that differ in the directions
    the right-hand side does not see, 1e-6 here. The Kelley point is an
    argmin of a model that sits at its floor, a flat region where HiGHS
    returns a vertex; on this input both packages get the same one. The
    SAA value estimates at 1e-6 relative."""
    ref, got = ssn_pair
    assert got["rounds"] == ref["rounds"] == ROUNDS
    for r in range(R):
        rc, gc = ref["cuts_per_rep"][r], got["cuts_per_rep"][r]
        assert len(gc) == len(rc) == 1 + 2 * (ROUNDS - 1)
        for g, c in zip(gc, rc):
            assert g[0] == c[0]
            assert g[1] == pytest.approx(c[1], rel=1e-6)
            np.testing.assert_allclose(g[2], c[2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["saa_ub_per_rep"], ref["saa_ub_per_rep"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["dual_infeas_per_rep"],
                               ref["dual_infeas_per_rep"], atol=1e-9)


def test_saa_polish_on_ssn_stays_at_the_floor(ssn_pair):
    """Both packages' bounds sit at the epigraph floor lb_e = 0, far below
    the SAA value estimates: the method on a fresh ssn stream, not the
    port."""
    ref, got = ssn_pair
    np.testing.assert_array_equal(ref["lb_per_rep"], 0.0)
    np.testing.assert_array_equal(got["lb_per_rep"], 0.0)
    assert np.all(got["saa_ub_per_rep"] > 10.0)
