"""One rank of the port's mesh tests (not a test module).

    python tests/_torch_mesh_worker.py MODE RANK WORLD PORT DIR

joins a Gloo group of WORLD CPU ranks at 127.0.0.1:PORT and runs MODE:

* ``combines``: the mesh's combines on panels the test planted in
  DIR/panels.npz; each rank writes DIR/combines<RANK>.npz;
* ``traj-1d`` / ``traj-2d``: lands in float64 on a 1-D mesh with the dual
  pool sharded too, or on a 2x2 (duals x scenarios) mesh; ``traj-cost``:
  newsprice (random costs: the seed dual is the pool's virtual row) on a
  1-D mesh with the pool sharded. One SD step per row of DIR/values.npy
  (``SDSolver.step_scenarios``), then the Monte-Carlo value of
  DIR/x_eval.npy and whether host sharpening refuses the mesh; rank 0
  writes these and the gathered state to DIR/traj.npz, every rank its
  replicated fields to DIR/rank<RANK>.npz.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

from sqlp_tpu_torch.config import PDHGConfig, QPConfig, SDConfig  # noqa
from sqlp_tpu_torch.parallel import distributed  # noqa: E402
from sqlp_tpu_torch.parallel import mesh as pm  # noqa: E402

# the capacities and tolerances of tests/test_parallel.py:47-52
CFG = SDConfig(dtype="float64", max_scenarios=256, max_dual_vertices=64,
               max_cuts=16, pdhg=PDHGConfig(tol=1e-8, max_iters=10_000),
               qp=QPConfig(tol=1e-9, max_iters=4_000))
X0 = np.full(4, 3.0)
SEED = 3
EVAL = dict(n_samples=256, batch=256, seed=77)
# the capacities of tests/test_torch_sd_gates.py's newsprice steps
COST_CFG = SDConfig(dtype="float64", max_scenarios=64, max_dual_vertices=64,
                    max_cuts=16)


def solver_of(mode, world, **mesh):
    """The solver a trajectory mode runs (``mesh``: the mesh arguments, none
    for the single-device run the tests compare with)."""
    from sqlp_tpu_torch.models.instance import load_instance
    from sqlp_tpu_torch.sd.driver import SDSolver

    if mode == "traj-cost":
        inst = load_instance("newsprice", dtype=torch.float64, device="cpu")
        return SDSolver(inst, COST_CFG, seed=0, **mesh)
    inst = load_instance("lands", dtype=torch.float64, device="cpu")
    return SDSolver(inst, CFG, x0=X0, seed=SEED, **mesh)


def combines(rank, world, out_dir):
    m = pm.make_mesh(world)
    ax = m.scen_axis
    with np.load(os.path.join(out_dir, "panels.npz")) as z:
        scores, values = z["scores"], z["values"]
    n = scores.shape[0] // world
    res = {}
    for name, eps in (("argmax", None), ("argmax_warm", 1e-4)):
        block = torch.as_tensor(scores[rank * n:(rank + 1) * n])
        res[name] = pm.global_quantized_argmax(block, ax, rank * n,
                                               eps=eps).numpy()
    k = values.shape[0] // world
    res["argmin"] = np.asarray(pm.global_argmin_lowest(
        torch.as_tensor(values[rank * k:(rank + 1) * k]), ax, rank * k))
    rows = torch.as_tensor(scores[rank * n:(rank + 1) * n])
    res["rows"] = pm.gather_rows(rows, torch.as_tensor(res["argmax"]), ax,
                                 rank * n).numpy()
    res["psum"] = pm.psum(torch.full((3,), float(rank + 1),
                                     dtype=torch.float64), ax).numpy()
    np.savez(os.path.join(out_dir, f"combines{rank}.npz"), **res)


def trajectory(mode, rank, world, out_dir):
    if mode == "traj-2d":
        solver = solver_of(mode, world, mesh_shape=(2, 2))
    else:
        solver = solver_of(mode, world, mesh_devices=world,
                           shard_duals=True)
    values = np.load(os.path.join(out_dir, "values.npy"))
    xs, n_duals, n_cuts = [], [], []
    for v in values:
        solver.step_scenarios(values=v)
        xs.append(solver.x_candidate)
        n_duals.append(int(solver.state.n_duals))
        n_cuts.append(int(torch.sum(solver.state.cut_live)))
    x_eval = np.load(os.path.join(out_dir, "x_eval.npy"))
    ub = solver.evaluate(x=x_eval, **EVAL)
    try:
        solver.sharpen_duals_host()
        sharpen_refused = False
    except ValueError:
        sharpen_refused = True
    n_checked = pm.check_replicated(solver.state, solver.mesh)
    specs = solver.mesh.specs()
    mine = {k: v.detach().numpy() for k, v in vars(solver.state).items()
            if not specs[k]}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **mine)
    full = pm.gather_state(solver.state, solver.mesh)
    if rank == 0:
        np.savez(os.path.join(out_dir, "traj.npz"), x=np.stack(xs),
                 n_duals=np.asarray(n_duals), n_cuts=np.asarray(n_cuts),
                 ub=ub, n_checked=n_checked, sharpen_refused=sharpen_refused,
                 **{"full_" + k: v.detach().numpy()
                    for k, v in vars(full).items()})


def main():
    mode, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    distributed.init_distributed(f"127.0.0.1:{port}", world, rank, "cpu",
                                 timeout_s=150)
    try:
        if mode == "combines":
            combines(rank, world, out_dir)
        else:
            trajectory(mode, rank, world, out_dir)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
