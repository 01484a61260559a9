"""The port's multi-device SD (``sqlp_tpu_torch/parallel/mesh.py``) against
the JAX package: the state's layout against JAX's shards on the 8 virtual
CPU devices, the combines on planted near-ties, and lands steps on a 1-D
mesh (dual pool sharded too) and a 2x2 mesh of four Gloo CPU ranks
against the JAX solver on one device; newsprice (random costs) on a 1-D
mesh of two against the port on one device. Every rank is a subprocess
of tests/_torch_mesh_worker.py with one intra-op thread."""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqlp_tpu.config import PDHGConfig as JPDHGConfig
from sqlp_tpu.config import QPConfig as JQPConfig
from sqlp_tpu.config import SDConfig as JSDConfig
from sqlp_tpu.config import autoscale_capacities as jax_autoscale
from sqlp_tpu.models.instance import load_instance as jax_load_instance
from sqlp_tpu.parallel import mesh as jax_mesh
from sqlp_tpu.sd.driver import SDSolver as JSDSolver
from sqlp_tpu.sd.state import default_epigraph_spec as jax_espec
from sqlp_tpu.sd.state import init_state as jax_init_state
from sqlp_tpu_torch.config import SDConfig, autoscale_capacities
from sqlp_tpu_torch.models.instance import load_instance
from sqlp_tpu_torch.parallel.mesh import (DUAL_AXIS, SCENARIO_AXIS,
                                          local_shard, state_pspecs)
from sqlp_tpu_torch.sd.cuts import quantized_argmax
from sqlp_tpu_torch.sd.driver import SDSolver

from test_torch_slice import _scenario_values

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_mesh_worker import CFG, EVAL, SEED, X0, solver_of  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
STEPS = 12
X_EVAL = np.array([2.0, 4.0, 3.0, 3.0])

JCFG = JSDConfig(dtype="float64", max_scenarios=256, max_dual_vertices=64,
                 max_cuts=16, pdhg=JPDHGConfig(tol=1e-8, max_iters=10_000),
                 qp=JQPConfig(tol=1e-9, max_iters=4_000))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(mode, world, out_dir):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), str(port),
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT, env=env) for r in range(world)]


def _wait_ranks(procs):
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("mesh ranks did not finish within 180 s")
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {i}:\n{log[-3000:]}" for i, log in enumerate(logs))


# ------------------------------------------------------------ (a) layout

def _random_like(state, rng):
    """A JAX state whose every field holds distinct random values."""
    kw = {}
    for f in dataclasses.fields(state):
        a = np.asarray(getattr(state, f.name))
        if a.dtype == bool:
            v = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.integer):
            v = rng.integers(0, 1000, a.shape).astype(a.dtype)
        else:
            v = rng.standard_normal(a.shape).astype(a.dtype)
        kw[f.name] = jnp.asarray(v)
    return dataclasses.replace(state, **kw)


@pytest.mark.parametrize("layout", ["1d", "1d_shard_duals", "2d"])
def test_layout_matches_jax_shards(layout):
    """Every field of the JAX package's ``shard_state`` on make_mesh(8)
    (with and without shard_duals) and make_mesh_2d(2, 4): each device's
    shard equals the port's ``local_shard`` at that device's mesh
    coordinates, exactly."""
    assert jax.device_count() >= 8
    inst = jax_load_instance("lands", dtype=jnp.float64)
    espec = jax_espec(1, 1.0, 0.0, dtype=jnp.float64)
    state = _random_like(jax_init_state(inst, espec, JCFG, X0,
                                        jax.random.PRNGKey(3)),
                         np.random.default_rng(0))
    if layout == "2d":
        mesh = jax_mesh.make_mesh_2d(2, 4)
        specs = state_pspecs(SCENARIO_AXIS, True, DUAL_AXIS)
        sharded = jax_mesh.shard_state(state, mesh)
    else:
        mesh = jax_mesh.make_mesh(8)
        duals = layout == "1d_shard_duals"
        specs = state_pspecs(SCENARIO_AXIS, duals)
        sharded = jax_mesh.shard_state(state, mesh, shard_duals=duals)
    shape = dict(mesh.shape)
    n_sharded = 0
    for f in dataclasses.fields(state):
        full = np.asarray(getattr(state, f.name))
        spec = specs[f.name]
        n_sharded += any(e is not None for e in spec)
        shards = getattr(sharded, f.name).addressable_shards
        assert len(shards) == 8
        for sh in shards:
            pos = np.argwhere(mesh.devices == sh.device)[0]
            coords = dict(zip(mesh.axis_names, (int(p) for p in pos)))
            np.testing.assert_array_equal(
                np.asarray(sh.data), local_shard(full, spec, shape, coords),
                err_msg=f"{layout} {f.name} at {coords}")
    assert n_sharded == (2 if layout == "1d" else 5)


@pytest.mark.parametrize("iters,mesh", [(40, 0), (40, 3), (2, 8), (300, 6),
                                        (10, 1)])
def test_autoscale_mesh_rounding_matches_jax(iters, mesh):
    """The scenario capacity stays a multiple of the mesh's scenario axis
    (sqlp_tpu/config.py:294-297)."""
    ours = autoscale_capacities(SDConfig(), iters, mesh_devices=mesh)
    ref = jax_autoscale(JSDConfig(), iters, mesh_devices=mesh)
    assert (ours.max_scenarios, ours.max_dual_vertices) == \
        (ref.max_scenarios, ref.max_dual_vertices)
    if mesh > 1:
        assert ours.max_scenarios % mesh == 0


@pytest.mark.parametrize("kw,msg", [
    (dict(shard_duals=True), "shard_duals needs a mesh"),
    (dict(mesh_devices=3), "max_scenarios 256 must divide"),
    (dict(mesh_shape=(3, 2)), "max_dual_vertices 64 must divide")])
def test_solver_refuses_meshes_it_cannot_lay(kw, msg):
    """Where the reference asserts (sqlp_tpu/sd/driver.py:169-176) or
    ignores shard_duals, the port raises ValueError, before any group is
    needed."""
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match=msg):
        SDSolver(inst, CFG, x0=X0, **kw)


# ---------------------------------------------------------- (b) combines

@pytest.fixture(scope="module")
def combines(tmp_path_factory):
    """A 4-rank group's combines on panels with planted near-ties across
    the shard edges (rows 0-3 on rank 0, 4-7 on rank 1, ...)."""
    out = tmp_path_factory.mktemp("combines")
    rng = np.random.default_rng(7)
    scores = rng.uniform(-1.0, 1.0, (16, 6))
    scores[3, 0], scores[4, 0] = 5.0, 5.0 + 1e-12   # one cell, ranks 0/1
    scores[7, 1] = scores[12, 1] = 3.0               # exact tie, ranks 1/3
    scores[:12, 2] = -np.inf                         # only rank 3 live
    scores[:, 3] = -np.inf                           # nothing live
    scores[0, 4], scores[15, 4] = 2.0, 2.0 + 1e-10   # one cell, ranks 0/3
    scores[11, 5] = 4.0                               # a clear winner
    values = rng.uniform(1.0, 2.0, 16)
    values[5] = values[9] = 0.25                      # equal, ranks 1/2
    np.savez(out / "panels.npz", scores=scores, values=values)
    _wait_ranks(_start_ranks("combines", 4, out))
    got = [dict(np.load(out / f"combines{r}.npz")) for r in range(4)]
    return scores, values, got


def test_global_quantized_argmax_matches_single_tensor(combines):
    """The winners over ranks equal ``quantized_argmax`` on the whole
    panel (the cut's eps) and the warm start's quantized pick (eps 1e-4),
    on every rank, near-ties and empty columns included."""
    scores, _, got = combines
    t = torch.as_tensor(scores)
    want = quantized_argmax(t).numpy()
    warm = torch.argmax(torch.floor(t / (1e-4 * (1.0 + torch.abs(
        torch.amax(t, dim=0))))), dim=0).numpy()
    assert want[0] == 3 and want[1] == 7 and want[4] == 0
    for g in got:
        np.testing.assert_array_equal(g["argmax"], want)
        np.testing.assert_array_equal(g["argmax_warm"][[0, 1, 2, 4, 5]],
                                      warm[[0, 1, 2, 4, 5]])


def test_global_argmin_lowest_and_row_gather(combines):
    """Equal lowest scores on ranks 1 and 2 evict the lower index, as
    ``torch.argmin`` does; the winners' rows come back exactly from
    their owners; the rank-order sum is the same on every rank."""
    scores, values, got = combines
    want = int(torch.argmin(torch.as_tensor(values)))
    assert want == 5
    rows = scores[quantized_argmax(torch.as_tensor(scores)).numpy()]
    for g in got:
        assert int(g["argmin"]) == want
        np.testing.assert_array_equal(g["rows"], rows)
        np.testing.assert_array_equal(g["psum"], np.full(3, 10.0))


# ------------------------------------------- (c), (d), (e) SD steps

# mode -> (ranks, steps, the seed of the numpy scenario values, x of the
# MC value); the seeds are those of the instances' streams in
# tests/test_torch_slice.py (lands) and tests/test_torch_sd_gates.py
# (newsprice)
RUNS = {"traj-1d": (4, STEPS, 11, X_EVAL), "traj-2d": (4, STEPS, 11, X_EVAL),
        "traj-cost": (2, 15, 21, np.array([5.0]))}
ALL = list(RUNS)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mode's ranks (all 10 processes at once), then here the JAX
    solver on lands and the port's single-device solver of each mode on
    the same scenario values."""
    dirs, procs, values = {}, {}, {}
    for mode, (world, steps, seed, x_eval) in RUNS.items():
        d = tmp_path_factory.mktemp(mode)
        single = solver_of(mode, 1)
        values[mode] = _scenario_values(single.inst, steps, seed)
        np.save(d / "values.npy", values[mode])
        np.save(d / "x_eval.npy", x_eval)
        dirs[mode] = d
        procs[mode] = _start_ranks(mode, world, d)
    js = JSDSolver(jax_load_instance("lands", dtype=jnp.float64), JCFG,
                   x0=X0, seed=SEED)
    jax_x = []
    for v in values["traj-1d"]:
        js.step_scenarios(values=v)
        jax_x.append(np.asarray(js.x_candidate))
    ref = {"x": np.stack(jax_x), "n_duals": int(js.state.n_duals),
           "n_cuts": int(jnp.sum(js.state.cut_live))}
    singles = {}
    for mode in ("traj-1d", "traj-cost"):
        ps = solver_of(mode, 1)
        xs = []
        for v in values[mode]:
            ps.step_scenarios(values=v)
            xs.append(ps.x_candidate)
        singles[mode] = (ps, np.stack(xs),
                         ps.evaluate(x=RUNS[mode][3], **EVAL))
    singles["traj-2d"] = singles["traj-1d"]
    for mode in procs:
        _wait_ranks(procs[mode])
    out = {}
    for mode, d in dirs.items():
        out[mode] = {"traj": dict(np.load(d / "traj.npz")),
                     "ranks": [dict(np.load(d / f"rank{r}.npz"))
                               for r in range(RUNS[mode][0])]}
    return ref, singles, out


@pytest.mark.parametrize("mode", ["traj-1d", "traj-2d"])
def test_mesh_steps_match_jax(mesh_runs, mode):
    """(c) x_candidate within 1e-8 of the JAX solver on one device at every
    step, n_duals within 1 and the same number of live cuts at the end
    (the gates of tests/test_parallel.py:156-200)."""
    ref, _, out = mesh_runs
    traj = out[mode]["traj"]
    for it in range(STEPS):
        np.testing.assert_allclose(traj["x"][it], ref["x"][it], atol=1e-8,
                                   err_msg=f"{mode} diverged at step {it}")
    assert abs(int(traj["n_duals"][-1]) - ref["n_duals"]) <= 1
    assert int(traj["n_cuts"][-1]) == ref["n_cuts"]


def test_random_cost_mesh_steps_match_single_device(mesh_runs):
    """newsprice's seed dual rides the sharded pool as its virtual row D,
    replicated and counted once: x_candidate within 1e-8 of the port on
    one device at every step."""
    _, singles, out = mesh_runs
    np.testing.assert_allclose(out["traj-cost"]["traj"]["x"],
                               singles["traj-cost"][1], atol=1e-8)


@pytest.mark.parametrize("mode", ALL)
def test_gathered_state_matches_single_device(mesh_runs, mode):
    """The mesh's state gathered from its shards is the port's
    single-device state: the scenario store bit for bit (each reservoir
    write landed on the rank that owns its slot), the pool's size and
    usage scores (to 1e-8), and its vertices at the pool's own admission
    bar, ``pdhg.valid_tol`` relative: each is a PDHG dual, and two runs
    whose warm starts differ at rounding level may stop the solve a round
    apart (newsprice's vertices part by 2e-6 at step 13 under the default
    tol 1e-7, while x stays within 1e-8). Host sharpening refused the
    mesh."""
    _, singles, out = mesh_runs
    ps = singles[mode][0]
    st = ps.state
    traj = out[mode]["traj"]
    np.testing.assert_array_equal(traj["full_scen_deltas"],
                                  st.scen_deltas.numpy())
    np.testing.assert_array_equal(traj["full_scen_weights"],
                                  st.scen_weights.numpy())
    assert int(traj["full_n_duals"]) == int(st.n_duals)
    duals = st.duals.numpy()
    np.testing.assert_allclose(
        traj["full_duals"], duals,
        atol=ps.config.pdhg.valid_tol * (1.0 + np.abs(duals).max()))
    np.testing.assert_allclose(traj["full_duals_score"],
                               st.duals_score.numpy(), atol=1e-8)
    assert bool(traj["sharpen_refused"])


@pytest.mark.parametrize("mode", ALL)
def test_sharded_mc_value_matches_single_process(mesh_runs, mode):
    """(d) The Monte-Carlo value at a fixed x with the panel's rows sharded
    over the ranks (each solves its block cold) against the port's single
    process on the same samples: within the PDHG tolerance relative to
    the value, ``pdhg.tol * (1 + |ub|)``."""
    _, singles, out = mesh_runs
    ps, _, ub_single = singles[mode]
    ub = float(out[mode]["traj"]["ub"])
    tol = ps.config.pdhg.tol * (1.0 + abs(ub_single))
    assert abs(ub - ub_single) <= tol, (ub, ub_single)


@pytest.mark.parametrize("mode", ALL)
def test_replicated_fields_agree_across_ranks(mesh_runs, mode):
    """(e) After the steps every replicated SDState field holds the same
    bits on every rank (and the ranks' own digest check counted them)."""
    _, _, out = mesh_runs
    ranks = out[mode]["ranks"]
    specs = state_pspecs(SCENARIO_AXIS, True,
                         DUAL_AXIS if mode == "traj-2d" else None)
    names = sorted(k for k, v in specs.items() if not v and k != "key")
    assert sorted(ranks[0]) == names
    assert int(out[mode]["traj"]["n_checked"]) == len(names)
    for r in range(1, len(ranks)):
        for k in names:
            assert ranks[r][k].dtype == ranks[0][k].dtype, k
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=f"rank {r} {k}")
