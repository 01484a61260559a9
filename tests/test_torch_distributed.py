"""The port's multi-process runs (``sqlp_tpu_torch/parallel/distributed.py``
and the CLI's ``--mesh`` / ``--coordinator``) on CPU ranks over Gloo: two
processes of one ``solve`` joined through ``--coordinator``, checkpoints
that cross between a 2-rank mesh and one process both ways, and the mesh
flags the CLI refuses. Every run is a subprocess with one intra-op
thread."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sqlp_tpu_torch.cli import main
from sqlp_tpu_torch.parallel import distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANDS_OPT = 381.8533333
ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _solve(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "sqlp_tpu_torch", "solve", "lands",
         "--device", "cpu", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=ENV)


def _wait(procs):
    """{name: (stdout, stderr)} once every process exited 0."""
    out = {}
    for name, p in procs.items():
        try:
            out[name] = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} did not finish within 180 s")
    bad = {k: v[1][-3000:] for k, v in out.items()
           if procs[k].returncode != 0}
    assert not bad, bad
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """All the CLI runs of this file, in two waves of concurrent
    processes: the coordinator pair, and the checkpoint chain (capacities
    fixed so the files resume across the runs; float64 and tight solver
    tolerances so the runs' states agree to rounding)."""
    d = tmp_path_factory.mktemp("cli")
    fixed = ["--dtype", "float64", "--no-auto-capacity", "--max-scenarios",
             "64", "--max-duals", "64", "--max-cuts", "16", "--sub-tol",
             "1e-8", "--master-tol", "1e-9", "--eval-samples", "64",
             "--seed", "5"]
    port = _free_port()
    pair = ["--iters", "40", "--mesh", "2", "--coordinator",
            f"127.0.0.1:{port}", "--num-processes", "2"]
    first = _wait({
        "rank0": _solve(*pair, "--process-id", "0"),
        "rank1": _solve(*pair, "--process-id", "1"),
        # U: one process, 16 iterations
        "U": _solve(*fixed, "--iters", "16", "--checkpoint", str(d / "U.npz")),
        # A: a 2-rank mesh (started by the command) for 8, checkpointed
        "A": _solve(*fixed, "--iters", "8", "--mesh", "2", "--shard-duals",
                    "--checkpoint", str(d / "A.npz")),
        # C: one process for 8, checkpointed
        "C": _solve(*fixed, "--iters", "8", "--checkpoint",
                    str(d / "C.npz"))})
    second = _wait({
        # B: one process resumes the mesh's file for 8 more
        "B": _solve(*fixed, "--iters", "8", "--resume", str(d / "A.npz"),
                    "--checkpoint", str(d / "B.npz")),
        # D: a 2x1 (duals x scenarios) mesh resumes one process's file
        "D": _solve(*fixed, "--iters", "8", "--mesh", "1", "--mesh-duals",
                    "2", "--resume", str(d / "C.npz"), "--checkpoint",
                    str(d / "D.npz"))})
    files = {k: dict(np.load(d / f"{k}.npz")) for k in "UABCD"}
    return {**first, **second}, files


def test_two_processes_through_coordinator(runs):
    """(f) Two processes of ``solve lands --mesh 2 --coordinator ...
    --iters 40`` exit 0; rank 0 alone prints, lb and ub within 6 of the
    lands optimum; the ranks chose Gloo on the shared CPU and their
    replicated state fields ended bitwise equal."""
    outs, _ = runs
    out0, err0 = outs["rank0"]
    out1, err1 = outs["rank1"]
    m = re.search(r"lb_est=(\S+) mc_ub=(\S+)", out0)
    assert m, out0
    lb, ub = float(m.group(1)), float(m.group(2))
    assert abs(lb - LANDS_OPT) < 6.0 and abs(ub - LANDS_OPT) < 6.0, (lb, ub)
    assert "mesh 2 (scenarios) over gloo: 2 ranks share the CPU" in err0
    assert "replicated state fields bitwise equal on 2 ranks" in err0
    assert out1 == "" and "lb_est" not in err1


@pytest.mark.parametrize("resumed,across", [("B", "A"), ("D", "C")],
                         ids=["mesh_to_single", "single_to_mesh"])
def test_checkpoint_resumes_across_the_mesh(runs, resumed, across):
    """(f) A 2-rank mesh's checkpoint (written whole by rank 0) resumes in
    one process, and one process's checkpoint resumes on a 2x1 mesh; 8 +
    8 iterations either way land where one process's 16 do: the same
    scenario store and generator state bit for bit, the same pool size,
    the decisions within 1e-8."""
    _, files = runs
    u, r, a = files["U"], files[resumed], files[across]
    assert set(a) == set(u)
    assert a["duals"].shape == u["duals"].shape      # written whole
    assert int(r["it"]) == int(u["it"]) == 16
    for k in ("scen_deltas", "scen_weights", "n_scen", "n_stream",
              "torch_generator_state", "n_duals"):
        np.testing.assert_array_equal(r[k], u[k], err_msg=k)
    for k in ("x_candidate", "x_incumbent"):
        np.testing.assert_allclose(r[k], u[k], atol=1e-8, err_msg=k)


@pytest.mark.parametrize("argv,msg", [
    (["solve", "lands", "--shard-duals"], "--shard-duals needs --mesh"),
    (["solve", "lands", "--mesh-duals", "2"], "--mesh-duals needs --mesh"),
    (["solve", "lands", "--mesh", "2", "--sharpen-every", "10"],
     "does not run on a mesh"),
    (["solve", "lands", "--cpu-devices-per-process", "4"],
     "is not ported to sqlp_tpu_torch: torch has no virtual devices"),
    (["solve", "lands", "--coordinator", "127.0.0.1:1"],
     "--coordinator needs a mesh"),
    (["solve", "lands", "--mesh", "2", "--coordinator", "127.0.0.1:1",
      "--num-processes", "3"], "must equal the mesh's 2 ranks"),
    (["solve", "lands", "--mesh", "2", "--coordinator", "127.0.0.1:1",
      "--num-processes", "2", "--process-id", "2"], "outside [0, 2)"),
    (["ef", "lands", "--mesh", "2"], "apply to solve only"),
    (["evaluate", "lands", "--shard-duals"], "apply to solve only")],
    ids=["shard_duals", "mesh_duals", "sharpen", "cpu_devices",
         "coordinator", "num_processes", "process_id", "ef", "evaluate"])
def test_cli_refuses_mesh_flags(argv, msg, capsys):
    """The mesh flags the CLI cannot honour exit 2 before any work. The
    reference ignores --shard-duals and --mesh-duals without --mesh
    (sqlp_tpu/sd/driver.py:164, sqlp_tpu/cli.py:93-94), crashes on an
    assert for --sharpen-every with --mesh (sqlp_tpu/sd/driver.py:423),
    and ignores the mesh flags of ef and evaluate."""
    assert main([*argv, "--device", "cpu"]) == 2
    assert msg in capsys.readouterr().err


def test_init_distributed_checks_its_rank():
    """A rank outside the group raises before any connection."""
    with pytest.raises(ValueError, match="outside"):
        distributed.init_distributed("127.0.0.1:1", 2, 2)
    assert distributed.backend() is None
