"""The PyTorch port's native (C++) SMPS parsers: exact equality with the
JAX package's Python parsers on the shipped instances (as
``tests/test_native.py`` holds the JAX package's own), the same malformed
files rejected, ``SQLP_TPU_TORCH_NATIVE=0``, a failed build that raises
with the compiler's message, and two processes that build at once."""

import os
import subprocess
import sys

import numpy as np
import pytest

import sqlp_tpu_torch.models.native as native
from sqlp_tpu.models.smps_cor import read_cor_py as jax_read_cor_py
from sqlp_tpu.models.smps_sto import read_sto_py as jax_read_sto_py
from sqlp_tpu_torch.models.smps_cor import read_cor
from sqlp_tpu_torch.models.smps_sto import read_sto

from conftest import require_instance

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["lands", "transship", "baa99-20", "storm", "ssn"]


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("SQLP_TPU_TORCH_NATIVE", raising=False)


@pytest.mark.parametrize("name", NAMES)
def test_native_cor_matches_jax_python_parser(name):
    path = os.path.join(require_instance(name), f"{name}.cor")
    a = read_cor(path)
    b = jax_read_cor_py(path)
    assert a.problem_name == b.problem_name
    assert a.directions == b.directions
    assert a.row_names == b.row_names
    assert a.col_names == b.col_names
    np.testing.assert_array_equal(a.template_matrix, b.template_matrix)
    np.testing.assert_array_equal(a.rhs, b.rhs)
    np.testing.assert_array_equal(a.lower_bound, b.lower_bound)
    np.testing.assert_array_equal(a.upper_bound, b.upper_bound)
    assert a.row_mapping == b.row_mapping
    assert a.col_mapping == b.col_mapping


@pytest.mark.parametrize("name", NAMES)
def test_native_sto_matches_jax_python_parser(name):
    path = os.path.join(require_instance(name), f"{name}.sto")
    a = read_sto(path)
    b = jax_read_sto_py(path)
    assert a.problem_name == b.problem_name
    assert [(p.col_name, p.row_name) for p in a.indep] == \
        [(p.col_name, p.row_name) for p in b.indep]
    for pa, pb in zip(a.indep, b.indep):
        da, db = a.indep[pa], b.indep[pb]
        assert type(da).__name__ == type(db).__name__, pb
        assert vars(da) == vars(db), pb


def test_native_sto_continuous_and_overwrite(tmp_path):
    """NORMAL / UNIFORM marginals and a later duplicate that overwrites a
    position, against the JAX package's Python parser."""
    p = tmp_path / "t.sto"
    p.write_text("STOCH  T\n"
                 "INDEP  NORMAL\n"
                 "    RHS    R1    4.0   2.0\n"
                 "INDEP  UNIFORM\n"
                 "    RHS    R2    1.0   3.0\n"
                 "    RHS    R1    0.0   9.0\n"
                 "ENDATA\n")
    a, b = read_sto(str(p)), jax_read_sto_py(str(p))
    assert [vars(d) for d in a.indep.values()] == \
        [vars(d) for d in b.indep.values()]


_HEAD = ("NAME T\nROWS\n N  OBJ\n L  C1\nCOLUMNS\n"
         "    X1  OBJ  1.0  C1  1.0\nRHS\n    R  C1  2.0\n")
_BAD = {
    "first_row_not_objective.cor": "ROWS\n L  C1\nENDATA\n",
    "bound_without_value.cor": _HEAD + "BOUNDS\n LO BND  X1\nENDATA\n",
    "non_numeric_bound.cor": _HEAD + "BOUNDS\n UP BND  X1  abc\nENDATA\n",
    "non_numeric_coefficient.cor": ("NAME T\nROWS\n N  OBJ\nCOLUMNS\n"
                                    "    X1  OBJ  xyz\nENDATA\n"),
    "blocks_section.sto": "STOCH X\nBLOCKS DISCRETE\nENDATA\n",
}


@pytest.mark.parametrize("fname", sorted(_BAD))
def test_native_rejects_bad_files(tmp_path, fname):
    """The malformed files of tests/test_native.py raise AssertionError
    through the port's native parser, as through the JAX package's."""
    p = tmp_path / fname
    p.write_text(_BAD[fname])
    with pytest.raises(AssertionError):
        (read_cor if fname.endswith(".cor") else read_sto)(str(p))


def test_env_selects_python_parsers(monkeypatch, lands_dir):
    """SQLP_TPU_TORCH_NATIVE=0: read_cor / read_sto never reach the
    native library, and give the same data."""
    def refuse(path):
        raise AssertionError("native parser called")

    native_cor = read_cor(os.path.join(lands_dir, "lands.cor"))
    monkeypatch.setenv("SQLP_TPU_TORCH_NATIVE", "0")
    monkeypatch.setattr(native, "read_cor_native", refuse)
    monkeypatch.setattr(native, "read_sto_native", refuse)
    cor = read_cor(os.path.join(lands_dir, "lands.cor"))
    read_sto(os.path.join(lands_dir, "lands.sto"))
    np.testing.assert_array_equal(cor.template_matrix,
                                  native_cor.template_matrix)


def test_failed_build_raises_compiler_message(tmp_path, monkeypatch):
    """A source g++ rejects: the build raises with g++'s message, leaves
    no library, and does not fall back."""
    for name in native._SOURCES:
        (tmp_path / name).write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="build failed") as exc:
        native.build()
    assert "error" in str(exc.value)
    assert not os.path.exists(native.library_path())


_CHILD = """
import sys
import sqlp_tpu_torch.models.native as native
native.BUILD_ROOT = sys.argv[1]
cor = native.read_cor_native(sys.argv[2])
print(native.library_path(), len(cor.row_names))
"""


def test_two_processes_build_at_once(tmp_path, lands_dir):
    """Two processes that find no library build it at the same time into
    one fresh directory: both load a whole library and parse, one file is
    left, and no temporary file."""
    root = str(tmp_path / "native")
    cor = os.path.join(lands_dir, "lands.cor")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, root, cor],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lib, rows = outs[0][0].split()
    assert outs[1][0].split() == [lib, rows] and int(rows) > 0
    assert os.listdir(os.path.dirname(lib)) == [os.path.basename(lib)]
