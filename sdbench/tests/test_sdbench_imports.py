"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program.

Module names are compared by their whole top-level name: the port's
``sqlp_tpu_torch`` is allowed, ``sqlp_tpu`` and ``jax`` are not.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

from sdbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "sqlp_tpu"}
# the pieces that decide ``correct`` or make the inputs: nothing of the
# program may reach them
PLAIN = ("smps.py", "sampler.py", "reference.py", "ef_reference.py",
         "roofline.py")
SOURCES = sorted(glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                           recursive=True))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, harness.ROOT)
                              for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("name", PLAIN)
def test_plain_pieces_import_nothing_of_the_program(name):
    mods = set(_imports(os.path.join(harness.HERE, name)))
    assert "sqlp_tpu_torch" not in mods and not mods & FORBIDDEN
    assert mods <= {"__future__", "numpy", "scipy", "torch", "sdbench",
                    "dataclasses", "os", "typing"}


_DRY = r"""
import sys, json, torch
torch.set_num_threads(2)
from sdbench import harness
from sdbench.run import forbidden_modules
cell = harness.load_cell(sys.argv[1])
cell.workload["params"].update(**json.loads(sys.argv[2]))
res = harness.run_cell(cell, seed=2**31 + 5, seconds=0.2, trace=False,
                       device="cpu")
bad = forbidden_modules()
print(json.dumps({"correct": res["correct"], "bad": bad}))
"""


@pytest.mark.parametrize("cell,small", [
    ("ssn.mc_ub", {"panel": 16, "check_rows": 4}),
    ("ssn.ef_cert", {"replications": 4, "scenarios": 24,
                     "check_rounds": 3, "rounds_per_call": 40})])
def test_dry_run_loads_no_jax(cell, small):
    import json
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _DRY, cell,
                          json.dumps(small)],
                         cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [] and res["correct"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import sdbench.reference, sdbench.ef_reference, "
            "sdbench.smps, sdbench.sampler, sdbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sqlp_tpu_torch', 'sqlp_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
