"""The port's instance compile (sqlp_tpu_torch/models) against the JAX
package's: the same SMPS files give bitwise equal arrays, for every
instance under instances/."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu_torch.models.instance import (ARRAY_FIELDS, instance_from_numpy,
                                            load_instance)
from sqlp_tpu_torch.models.scenario import (SCENARIO_FIELDS, sample_deltas,
                                            sample_values)

torch.set_num_threads(1)

INSTANCES = sorted(
    d for d in os.listdir(os.path.join(os.path.dirname(__file__), "..",
                                       "instances"))
    if os.path.isfile(os.path.join(os.path.dirname(__file__), "..",
                                   "instances", d, f"{d}.cor")))


def _assert_same(port_inst, jax_inst):
    """Bitwise equality (tolerance 0): both packages run the same host
    numpy compile and round float64 to the target type the same way."""
    for f in ARRAY_FIELDS:
        a = getattr(port_inst.arrays, f).cpu().numpy()
        b = np.asarray(getattr(jax_inst.arrays, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
        if b.dtype.kind == "f":
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
    pm, jm = port_inst.scenario_model, jax_inst.scenario_model
    for f in SCENARIO_FIELDS:
        np.testing.assert_array_equal(getattr(pm, f).cpu().numpy(),
                                      np.asarray(getattr(jm, f)),
                                      err_msg=f)
    assert (pm.has_cost, pm.seed_valid, pm.cost_idx) == (
        jm.has_cost, jm.seed_valid, jm.cost_idx)
    assert (port_inst.n1, port_inst.m1, port_inst.n2, port_inst.m2,
            port_inst.n_rv) == (jax_inst.n1, jax_inst.m1, jax_inst.n2,
                                jax_inst.m2, jax_inst.n_rv)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", INSTANCES)
def test_instance_arrays_bitwise_equal(name, dtype):
    port = load_instance(name, dtype=getattr(torch, dtype), device="cpu")
    ref = jax_load_instance(name, dtype=getattr(jnp, dtype))
    _assert_same(port, ref)


def test_instance_from_numpy_round_trip():
    """instance_from_numpy carries the JAX instance's arrays over as they
    are (dtype inferred)."""
    ref = jax_load_instance("transship", dtype=jnp.float64)
    port = instance_from_numpy(ref, device="cpu")
    assert port.arrays.W.dtype == torch.float64
    _assert_same(port, ref)


def test_iid_sampling_matches_marginals():
    """iid draws from an explicit generator follow the sto marginals: lands'
    demand takes 3 / 5 / 7 with probabilities 0.3 / 0.4 / 0.3 (tolerance
    0.01: four standard errors at 40000 draws); the same seed repeats the
    panel exactly; an antithetic panel pairs its halves as (u, 1 - u), so
    the demand's 3 / 7 outcomes mirror and 5 stays 5."""
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    m = inst.scenario_model
    g = torch.Generator().manual_seed(3)
    v = sample_values(g, m, 40_000)[:, 0].numpy()
    for val, p in ((3.0, 0.3), (5.0, 0.4), (7.0, 0.3)):
        assert abs(np.mean(v == val) - p) < 0.01
    a = sample_deltas(torch.Generator().manual_seed(5), m, 16)
    b = sample_deltas(torch.Generator().manual_seed(5), m, 16)
    assert torch.equal(a, b)
    anti = sample_values(g, m, 16, method="antithetic")[:, 0].numpy()
    np.testing.assert_array_equal(anti[:8] + anti[8:], np.full(8, 10.0))
